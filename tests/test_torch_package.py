"""Boundaries of the torch port: it imports neither JAX nor the JAX
package, sets the full-f32 matmul flags, and its chip smoke script fails
cleanly where there is no GPU."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "pyslam_tpu_torch"
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|pyslam_tpu)\b", re.M)


def _run(code, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_import_leaves_jax_out():
    proc = _run(
        "import sys, pyslam_tpu_torch\n"
        "import pyslam_tpu_torch.solver.cuda_ops, pyslam_tpu_torch._ext\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pyslam_tpu'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", ["package", "chip_smoke.py", "profile_port.py"])
def test_sources_do_not_import_jax(path):
    files = sorted(PKG.rglob("*.py")) if path == "package" else [ROOT / path]
    assert files
    offenders = [str(f.relative_to(ROOT)) for f in files if _IMPORT.search(f.read_text())]
    assert not offenders


def test_chip_smoke_fails_without_a_gpu():
    """Here (no CUDA device) the smoke script exits non-zero and prints no
    result line."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    if proc.returncode == 0:
        pytest.skip("a CUDA device is present: the script ran for real")
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr or "cuda" in proc.stderr.lower()
