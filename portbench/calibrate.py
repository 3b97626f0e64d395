"""The readings the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python3 portbench/calibrate.py --workload sphere30k.solve --seeds 11-22 --control-seeds 31-33

For each of ``--seeds``, the program's solve of the seed's problem (after
one warm-up solve, as in a run), judged against the float64 reference: the
lower readings.  For each of ``--control-seeds``, the control (the
reference computed with every matrix product in TF32, ``arith.Arith``) put
in the program's place and judged the same way: the upper readings.  One
JSON line a reading goes to standard output, then a summary line of each
number's largest sound reading and smallest control reading.  The
benchmark's own runs never run the control."""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _seeds(text):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _lm_history(info) -> list:
    """(accepted, cost after the iteration) of each iteration of a
    ``SolveInfo``."""
    n = int(info.iterations)
    return list(zip(info.accepted[:n].tolist(), info.cost_history[1:n + 1].tolist()))


def _compare(program, reference) -> dict:
    """Where the LM decisions of two solves part, and their costs' relative
    gap after each tenth of the iterations."""
    flags = ["".join("1" if a else "0" for a, _ in h) for h in (program, reference)]
    first = next((i for i, (a, b) in enumerate(zip(*flags)) if a != b), None)
    n = min(len(program), len(reference))
    gaps = {i + 1: abs(program[i][1] - reference[i][1]) / reference[i][1] for i in range(0, n, max(1, n // 10))}
    return dict(program_accepted=flags[0], reference_accepted=flags[1], first_difference=first, cost_gaps=gaps)


def readings(workload, seeds, control_seeds, device, config=None, histories=False):
    """Yield one dict a seed: the kind ('program' or 'control'), the seed
    and the judge's numbers; with ``histories`` also where the program's LM
    decisions part from the reference's (``lm.solve``'s solves)."""
    import importlib

    import torch

    from portbench import harness, judge
    from portbench.arith import Arith

    manifest = harness.load_manifest(ROOT)
    cell = harness.cell_of(manifest, workload)
    cfg = config if config is not None else harness.config_of(manifest, cell["config"], ROOT)
    gen = importlib.import_module(f"portbench.generators.{cfg['generator']}")
    entry = importlib.import_module(f"portbench.entries.{cfg['entry']}")
    ref = importlib.import_module(f"portbench.references.{cfg['reference']}")
    for kind, seed in [("program", s) for s in seeds] + [("control", s) for s in control_seeds]:
        t0 = time.perf_counter()
        problem = gen.generate(cfg["sizes"], seed, device)
        seen = []
        if kind == "program":
            state = entry.build(problem, cfg, device)
            entry.plan(state)
            entry.restore(state)
            entry.solve(state)  # the warm-up, as in a run
            entry.restore(state)
            if histories:
                from pyslam_tpu_torch.solver import lm

                solve = lm.solve
                lm.solve = lambda *a, **k: seen.append(solve(*a, **k)) or seen[-1]
            try:
                answer = entry.solve(state)
            finally:
                if histories:
                    lm.solve = solve
            del state
        else:
            answer = ref.solve(problem, cfg, Arith(torch.float32, tf32=True))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        against = judge.reference_answer(ref, problem, cfg, Arith())
        nums = judge.numbers(ref, problem, answer, against)
        row = dict(kind=kind, seed=seed, chi2=answer["chi2"], reference_chi2=against["chi2"],
                   reference_iterations=against["iterations"], seconds=time.perf_counter() - t0, **nums)
        if seen:
            row.update(_compare(_lm_history(seen[-1][1]), against["history"]))
        yield row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--histories", action="store_true", help="where the LM decisions part (lm.solve's solves)")
    args = ap.parse_args(argv)
    import torch

    from portbench import judge

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    rows = []
    for row in readings(args.workload, args.seeds, args.control_seeds, "cuda:0", histories=args.histories):
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for k in judge.NUMBERS:
        sound = [r[k] for r in rows if r["kind"] == "program"]
        control = [r[k] for r in rows if r["kind"] == "control"]
        summary[k] = dict(lower=max(sound) if sound else None, upper=min(control) if control else None)
    print(json.dumps(dict(workload=args.workload, summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
