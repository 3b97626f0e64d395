"""The benchmark of pyslam_tpu_torch on NVIDIA H100 cards: one run of one
cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload venice_ba.solve --seed 7 --seconds 20 --trace 0

Run from the root of a checkout.  Prints one JSON object as the last line
of standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``; ``checks`` last: every
number compared with the plain reference, beside its limit) and the same
checks as the last lines of standard error.  Without a CUDA card, or with
fewer cards than the cell asks for, it prints no result and exits 2; if
JAX or the JAX package was loaded, it exits 3."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that the run may not hold once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "pyslam_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is a forbidden one, compared as a
    whole name (``pyslam_tpu_torch`` is not ``pyslam_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout (the
    # program's own kernel library goes to build/pyslam_tpu_torch/<hash>)
    caches = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(caches / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(caches / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(caches / "cuda")
    os.environ["USE_FLAX"] = "0"

    import torch

    from portbench import harness

    manifest = harness.load_manifest(ROOT)
    cell = harness.cell_of(manifest, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s), found {n}; no result",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(f"portbench: card {_power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
