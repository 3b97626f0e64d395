"""The CUDA kernels of the torch port against their plain PyTorch versions,
on the card.  Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
only the port's dependencies are installed; ``tests/conftest.py`` imports
JAX, so run it there with ``--noconftest``:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerances, relative to the largest reference entry: 1e-5 in f32 and 1e-12
in f64 (the kernel sums the same terms as the plain version, in another
order); 1e-8 on chi2 and 1e-6 on poses for a whole solve, as against the
JAX reference.
"""

import numpy as np
import pytest
import torch

from pyslam_tpu_torch.graph import build
from pyslam_tpu_torch.io import synth
from pyslam_tpu_torch.solver import assemble, bcsr, cuda_ops, lm
from pyslam_tpu_torch.solver.cuda_ops import (
    ell_matvec,
    ell_matvec_plain,
    slot_reduce,
    slot_reduce_plain,
)
from pyslam_tpu_torch.solver.lm import Options

DENSE_GRAPHS = {
    "se2": lambda: synth.se2_loop(n_poses=30, n_loops=4, seed=0),
    "sim3": lambda: synth.sim3_loop(n_poses=40, n_loops=3, scale_drift=0.005, seed=0),
}

KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _random_ell(nb, K, d, seed, device, dtype):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, nb, size=(nb, K)).astype(np.int32)
    cols[:, 0] = np.arange(nb)
    He = torch.from_numpy(rng.normal(size=(nb, K, d, d))).to(device, dtype)
    x = torch.from_numpy(rng.normal(size=nb * d)).to(device, dtype)
    return He, torch.from_numpy(cols).to(device), x


def _assert_close(out, ref, rel):
    err = (out - ref).abs().max().item()
    assert err <= rel * ref.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,K,d", [(2500, 9, 6), (300, 5, 3), (1, 1, 6)])
def test_ell_matvec_kernel_matches_plain(cuda_device, nb, K, d, dtype):
    He, cols, x = _random_ell(nb, K, d, 4, cuda_device, dtype)
    cuda_ops.reset_launches()
    out = ell_matvec(He, cols, x)
    ref = ell_matvec_plain(He, cols, x)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["ell_matvec"] == 1
    _assert_close(out, ref, KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_slots,E,C", [(22500, 19792, 36), (2500, 9896, 6), (10, 0, 36)])
def test_slot_reduce_kernel_matches_plain(cuda_device, n_slots, E, C, dtype):
    rng = np.random.default_rng(5)
    plan = bcsr.slot_plan(rng.integers(0, n_slots, E), n_slots)
    contrib = torch.from_numpy(rng.normal(size=(E, C))).to(cuda_device, dtype)
    perm = torch.from_numpy(plan.perm).to(cuda_device)
    offsets = torch.from_numpy(plan.offsets).to(cuda_device)
    cuda_ops.reset_launches()
    out = slot_reduce(contrib, perm, offsets, n_slots)
    again = slot_reduce(contrib, perm, offsets, n_slots)
    ref = slot_reduce_plain(contrib, perm, offsets, n_slots)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["slot_reduce"] == 2
    assert torch.equal(out, again)  # no atomics: the same bits every run
    if E:
        _assert_close(out, ref, KERNEL_TOL[dtype])
    else:
        assert not out.any()


def test_wrappers_refuse_mixed_devices(cuda_device):
    He, cols, x = _random_ell(8, 3, 6, 1, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="different devices"):
        ell_matvec(He, cols.cpu(), x)


def _sphere(device):
    return build.pose_graph(synth.se3_sphere(n_poses=60, seed=11), dtype=torch.float64, device=device)


def test_assemble_ell_on_the_card_matches_cpu(cuda_device):
    out = {}
    for dev in ("cpu", cuda_device):
        g = _sphere(dev)
        out[str(dev)] = bcsr.assemble_ell(g, bcsr.ell_device_plan(bcsr.build_ell_direct(g), dev))
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        _assert_close(b.cpu(), a, 1e-12)


@pytest.mark.parametrize("method", ["lm", "gn"])
def test_solve_ell_on_the_card_matches_cpu(cuda_device, method):
    opts = Options(method=method, max_iters=15)
    s_cpu, i_cpu = bcsr.solve_ell(_sphere("cpu"), opts)
    cuda_ops.reset_launches()
    s_gpu, i_gpu = bcsr.solve_ell(_sphere(cuda_device), opts)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["ell_matvec"] > 0 and cuda_ops.LAUNCHES["slot_reduce"] > 0
    assert cuda_ops.LAUNCHES["ell_matvec_plain"] == 0 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    assert (i_gpu.iterations, i_gpu.status) == (i_cpu.iterations, i_cpu.status)
    np.testing.assert_allclose(i_gpu.chi2.item(), i_cpu.chi2.item(), rtol=1e-8)
    np.testing.assert_allclose(
        s_gpu.blocks["poses"].values.cpu().numpy(), s_cpu.blocks["poses"].values.numpy(), rtol=0, atol=1e-6
    )


def _dense_graph(name, device):
    return build.pose_graph(DENSE_GRAPHS[name](), dtype=torch.float64, device=device)


@pytest.mark.parametrize("name", sorted(DENSE_GRAPHS))
def test_assemble_dense_on_the_card_matches_cpu(cuda_device, name):
    ref = assemble.assemble_dense(_dense_graph(name, "cpu"))
    cuda_ops.reset_launches()
    out = assemble.assemble_dense(_dense_graph(name, cuda_device))
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["slot_reduce"] == 2 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    for a, b in zip(ref, out):
        _assert_close(b.cpu(), a, 1e-12)


@pytest.mark.parametrize("name", sorted(DENSE_GRAPHS))
def test_assemble_dense_on_the_card_is_deterministic(cuda_device, name):
    g = _dense_graph(name, cuda_device)
    plan = assemble.dense_plan(g)
    first = assemble.assemble_dense(g, plan)
    second = assemble.assemble_dense(g, plan)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)  # no atomics: the same bits every run


@pytest.mark.parametrize("method", ["lm", "gn", "dogleg"])
def test_dense_solve_on_the_card_matches_cpu(cuda_device, method):
    opts = Options(method=method, max_iters=20)
    s_cpu, i_cpu = lm.solve(_dense_graph("se2", "cpu"), opts)
    s_gpu, i_gpu = lm.solve(_dense_graph("se2", cuda_device), opts)
    assert (i_gpu.iterations, i_gpu.status) == (i_cpu.iterations, i_cpu.status)
    np.testing.assert_allclose(i_gpu.chi2.item(), i_cpu.chi2.item(), rtol=1e-8)
    np.testing.assert_allclose(
        s_gpu.blocks["poses"].values.cpu().numpy(), s_cpu.blocks["poses"].values.numpy(), rtol=0, atol=1e-6
    )
