"""Boundaries of the torch port: it imports neither JAX nor the JAX
package, sets the full-f32 matmul flags, builds on the CUDA device unless
the caller asks for the CPU, and its chip smoke script fails cleanly where
there is no GPU."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pyslam_tpu_torch
from pyslam_tpu_torch.graph import build, convert
from pyslam_tpu_torch.io import synth
from pyslam_tpu_torch.lie import se2, se3, sim3, so2, so3
from pyslam_tpu_torch.testing import se3_stress_graph

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


_BLOCK = dict(kind="se2", values=np.eye(3)[None], const_mask=np.zeros(1, bool))
DEFAULT_DEVICE_ENTRY_POINTS = {
    "default_device": pyslam_tpu_torch.default_device,
    "pose_graph": lambda **kw: build.pose_graph(synth.se2_loop(n_poses=6, n_loops=1, seed=0), **kw),
    "sim3_pose_graph": lambda **kw: build.sim3_pose_graph(synth.sim3_loop(n_poses=6, n_loops=1, seed=0), **kw),
    "graph_from_numpy": lambda **kw: convert.graph_from_numpy({"poses": _BLOCK}, [], torch.float64, **kw),
    "se3_stress_graph": lambda **kw: se3_stress_graph(n_poses=24, **kw),
    "so2.identity": so2.identity,
    "se2.identity": se2.identity,
    "so3.identity": so3.identity,
    "se3.identity": se3.identity,
    "sim3.identity": sim3.identity,
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_ENTRY_POINTS))
def test_entry_points_default_to_the_cuda_device(name):
    """With no device given an entry point builds on the card; where there
    is none it raises, and the message says how to ask for the CPU.  It
    never falls back to the CPU by itself."""
    fn = DEFAULT_DEVICE_ENTRY_POINTS[name]
    if torch.cuda.is_available():
        out = fn()
        device = out if isinstance(out, torch.device) else (
            out.device if torch.is_tensor(out) else out.blocks["poses"].values.device)
        assert device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()
    if name != "default_device":
        out = fn(device="cpu")
        values = out if torch.is_tensor(out) else out.blocks["poses"].values
        assert values.device.type == "cpu"


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
