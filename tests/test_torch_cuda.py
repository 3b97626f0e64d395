"""The CUDA kernels of the torch port against their plain PyTorch versions,
on the card.  Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
only the port's dependencies are installed; ``tests/conftest.py`` imports
JAX, so run it there with ``--noconftest``:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerances, relative to the largest reference entry: 1e-5 in f32 and 1e-12
in f64 (the kernel sums the same terms as the plain version, in another
order); 1e-8 on chi2 and 1e-6 on poses for a whole solve, as against the
JAX reference.  ``ell_pcg`` runs many dependent iterations, each with its
dot products summed in another order than ``torch.dot``: see ``PCG_TOL``.
"""

import numpy as np
import pytest
import torch

from pyslam_tpu_torch.graph import build
from pyslam_tpu_torch.io import synth
from pyslam_tpu_torch.solver import assemble, bcsr, cuda_ops, linear, lm
from pyslam_tpu_torch.solver.cuda_ops import (
    ell_matvec,
    ell_matvec_plain,
    ell_pcg,
    ell_pcg_plain,
    slot_reduce,
    slot_reduce_plain,
)
from pyslam_tpu_torch.solver.lm import Options

DENSE_GRAPHS = {
    "se2": lambda: synth.se2_loop(n_poses=30, n_loops=4, seed=0),
    "sim3": lambda: synth.sim3_loop(n_poses=40, n_loops=3, scale_drift=0.005, seed=0),
}

KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# ell_pcg against ell_pcg_plain on the block-diagonally dominant systems of
# _spd_ell (condition number of the preconditioned matrix below 10): x
# relative to its largest entry, and the iteration counts' difference.  In
# f64 rounding differences of 1e-16 a step cannot move a stop test or the
# solution beyond 1e-10.  In f32 both are solutions to the stop tolerance
# (1e-5 of norm(b)), so they agree to about that times the condition number,
# and a run that stops near the tolerance may do so one iteration apart.
PCG_TOL = {torch.float32: (2e-4, 1), torch.float64: (1e-10, 0)}
PCG_RTOL = {torch.float32: 1e-5, torch.float64: 1e-10}


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


def _spd_ell(nb, K, d, seed, device, dtype):
    """A symmetric positive definite ELL system (He, cols, Minv, b): row r
    couples to rows r +- o (mod nb) for (K - 1) // 2 offsets o, each pair
    stored in both rows as a block and its transpose; an even K leaves the
    last slot as padding (zero block, its column the row itself).  The
    diagonal blocks dominate their rows."""
    rng = np.random.default_rng(seed)
    He = np.zeros((nb, K, d, d))
    rows = np.arange(nb)
    cols = np.tile(rows.astype(np.int32)[:, None], (1, K))
    for m, o in enumerate(rng.choice(np.arange(1, max(2, nb)), size=(K - 1) // 2, replace=nb <= K)):
        B = 0.3 * rng.normal(size=(nb, d, d))
        He[rows, 1 + 2 * m], cols[rows, 1 + 2 * m] = B, (rows + o) % nb
        He[(rows + o) % nb, 2 + 2 * m], cols[(rows + o) % nb, 2 + 2 * m] = B.transpose(0, 2, 1), rows
    A = rng.normal(size=(nb, d, d))
    He[:, 0] = A @ A.transpose(0, 2, 1) + (1.0 + np.abs(He[:, 1:]).sum((1, 2, 3)))[:, None, None] * np.eye(d)
    He_t = torch.from_numpy(He).to(device, dtype)
    Minv = torch.linalg.inv(He_t[:, 0]).contiguous()
    b = torch.from_numpy(rng.normal(size=nb * d)).to(device, dtype)
    return He_t, torch.from_numpy(cols).to(device), Minv, b


# the last is past what shared memory holds (38.9 MB of He in f32)
PCG_SHAPES = [(2500, 9, 6), (300, 5, 3), (1, 1, 6), (30000, 9, 6)]


@pytest.mark.parametrize("stop", ["tolerance", "max_iters"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,K,d", PCG_SHAPES)
def test_ell_pcg_kernel_matches_plain(cuda_device, nb, K, d, dtype, stop):
    He, cols, Minv, b = _spd_ell(nb, K, d, 6, cuda_device, dtype)
    # with one block row block-Jacobi is the exact inverse: one iteration
    rtol, max_iters = (PCG_RTOL[dtype], 200) if stop == "tolerance" else (0.0, 5 if nb > 1 else 1)
    cuda_ops.reset_launches()
    linear.reset_host_reads()
    out = ell_pcg(He, cols, Minv, b, rtol, max_iters)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["ell_pcg"] == 1 and cuda_ops.LAUNCHES["ell_pcg_plain"] == 0
    assert linear.HOST_READS["pcg"] == 0  # the loop and its stop test stay on the device
    ref = ell_pcg_plain(He, cols, Minv, b, rtol, max_iters)
    x_tol, it_tol = PCG_TOL[dtype]
    it, it_ref = int(out.iterations), int(ref.iterations)
    assert cuda_ops.pcg_iterations() == it
    if stop == "max_iters":
        assert it == it_ref == max_iters
    else:
        assert 0 < it_ref < max_iters and abs(it - it_ref) <= it_tol
    _assert_close(out.x, ref.x, x_tol)
    resident = He.element_size() * nb * K * d * d < 20e6
    assert out.resident_rows == nb if resident else 0 < out.resident_rows < nb


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,K,d", [(2500, 9, 6), (30000, 9, 6)])
def test_ell_pcg_kernel_is_deterministic(cuda_device, nb, K, d, dtype):
    He, cols, Minv, b = _spd_ell(nb, K, d, 7, cuda_device, dtype)
    first = ell_pcg(He, cols, Minv, b, PCG_RTOL[dtype], 200)
    second = ell_pcg(He, cols, Minv, b, PCG_RTOL[dtype], 200)
    torch.cuda.synchronize()
    assert torch.equal(first.x, second.x)  # ordered sums, no atomics: the same bits every run
    assert int(first.iterations) == int(second.iterations) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("where", ["b", "Minv", "He"])
def test_ell_pcg_kernel_nan_in_nan_out(cuda_device, where, dtype):
    """A NaN ends the loop at the next stop test and nothing traps.  NaN
    in b: no iteration, x = x0 = 0, as the plain version.  NaN in Minv or
    He: one iteration, NaN in x (the plain version, whose r0 = b - A x0
    meets a NaN in He before the loop, stops at once with x = 0: either
    way a step that LM rejects)."""
    He, cols, Minv, b = _spd_ell(300, 5, 3, 8, cuda_device, dtype)
    dict(b=b, Minv=Minv, He=He)[where].view(-1)[7] = float("nan")
    out = ell_pcg(He, cols, Minv, b, 1e-6, 50)
    torch.cuda.synchronize()
    if where == "b":
        assert int(out.iterations) == 0 and not out.x.any()
    else:
        assert int(out.iterations) == 1 and torch.isnan(out.x).any()


def test_ell_pcg_zero_rhs_and_zero_budget(cuda_device):
    He, cols, Minv, b = _spd_ell(300, 5, 3, 9, cuda_device, torch.float32)
    for rhs, budget in ((torch.zeros_like(b), 50), (b, 0)):
        out = ell_pcg(He, cols, Minv, rhs, 1e-6, budget)
        assert int(out.iterations) == 0 and not out.x.any()


def test_wrappers_refuse_mixed_devices(cuda_device):
    He, cols, x = _random_ell(8, 3, 6, 1, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="different devices"):
        ell_matvec(He, cols.cpu(), x)
    He, cols, Minv, b = _spd_ell(8, 3, 6, 1, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="different devices"):
        ell_pcg(He, cols, Minv.cpu(), b, 1e-6, 10)


def _sphere(device):
    return build.pose_graph(synth.se3_sphere(n_poses=60, seed=11), dtype=torch.float64, device=device)


def test_assemble_ell_on_the_card_matches_cpu(cuda_device):
    out = {}
    for dev in ("cpu", cuda_device):
        g = _sphere(dev)
        out[str(dev)] = bcsr.assemble_ell(g, bcsr.ell_device_plan(bcsr.build_ell_direct(g), dev))
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        _assert_close(b.cpu(), a, 1e-12)


@pytest.mark.parametrize("method", ["lm", "gn", "dogleg"])
def test_solve_ell_on_the_card_matches_cpu(cuda_device, method):
    opts = Options(method=method, max_iters=15)
    s_cpu, i_cpu = bcsr.solve_ell(_sphere("cpu"), opts)
    cuda_ops.reset_launches()
    linear.reset_host_reads()
    s_gpu, i_gpu = bcsr.solve_ell(_sphere(cuda_device), opts)
    torch.cuda.synchronize()
    launches = cuda_ops.LAUNCHES
    # one PCG launch per linear solve, no CG stop test read by the host;
    # dogleg's two model products per iteration go through ell_matvec
    assert launches["ell_pcg"] == i_gpu.iterations and launches["slot_reduce"] > 0
    assert launches["ell_matvec"] == (2 * i_gpu.iterations if method == "dogleg" else 0)
    assert not any(n for k, n in launches.items() if k.endswith("_plain"))
    assert linear.HOST_READS == {"pcg": 0, "lm": i_gpu.iterations}
    assert cuda_ops.pcg_iterations() > 0
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
