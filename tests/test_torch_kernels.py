"""The two kernel wrappers of ``pyslam_tpu_torch.solver.cuda_ops``.

On the CPU each wrapper runs its plain PyTorch version, which is checked
here against the Pallas kernel it replaces (``pallas_ops``, in interpret
mode, as ``tests/test_pallas_ops.py`` runs it) and against an independent
reference (``assemble_dense @ x``, ``np.add.at``).  Tolerances: 1e-12 in
f64; 1e-5 where the Pallas ``scatter_matmul`` runs in f32, as in its own
test.  The kernels themselves are checked against these plain versions on
the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.io import synth
from pyslam_tpu.solver.assemble import assemble_dense
from pyslam_tpu.solver.bcsr import assemble_ell as j_assemble_ell
from pyslam_tpu.solver.bcsr import build_ell_direct as j_build_ell_direct
from pyslam_tpu.solver.pallas_ops import ell_matvec_pallas, scatter_matmul
from pyslam_tpu_torch import _ext
from pyslam_tpu_torch.solver import cuda_ops
from pyslam_tpu_torch.solver.bcsr import slot_plan
from pyslam_tpu_torch.solver.cuda_ops import ell_matvec, slot_reduce


def _random_ell(nb, K, d, seed):
    rng = np.random.default_rng(seed)
    He = rng.normal(size=(nb, K, d, d))
    cols = rng.integers(0, nb, size=(nb, K)).astype(np.int32)
    cols[:, 0] = np.arange(nb)
    x = rng.normal(size=nb * d)
    return He, cols, x


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# --------------------------------------------------------------------------
# ell_matvec
# --------------------------------------------------------------------------


@pytest.mark.parametrize("nb,K,d", [(64, 5, 6), (30, 4, 3), (17, 7, 2)])
def test_ell_matvec_plain_matches_pallas(nb, K, d):
    He, cols, x = _random_ell(nb, K, d, seed=nb)
    ref = ell_matvec_pallas(jnp.asarray(He), jnp.asarray(cols), jnp.asarray(x), interpret=True)
    out = ell_matvec(_t(He), _t(cols), _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_ell_matvec_plain_matches_dense_system():
    """On a real ELL store (se3_sphere, assembled by the reference), the
    matvec equals the dense Hessian product."""
    g = jbuild.pose_graph(synth.se3_sphere(n_poses=60, seed=11), dtype=jnp.float64)
    plan = j_build_ell_direct(g)
    He, _, _ = j_assemble_ell(g, plan)
    Hd, _, _ = assemble_dense(g)
    x = np.random.default_rng(0).normal(size=Hd.shape[0])
    y = ell_matvec(_t(He), _t(plan.cols.astype(np.int32)), _t(x))
    ref = np.asarray(Hd) @ x
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())


# --------------------------------------------------------------------------
# slot_reduce
# --------------------------------------------------------------------------


def _sorted_contrib(dtype):
    """The inputs of tests/test_pallas_ops.py::TestScatterMatmul."""
    rng = np.random.default_rng(3)
    S_pad, E, C = 512, 700, 36
    sid = np.sort(rng.integers(0, S_pad, E)).astype(np.int32)
    contrib = rng.normal(0, 1, (E, C)).astype(dtype)
    return sid, contrib, S_pad


def test_slot_reduce_plain_matches_scatter_matmul():
    sid, contrib, S_pad = _sorted_contrib(np.float32)
    T, E, C = 128, len(sid), contrib.shape[1]
    grid = S_pad // T
    starts = np.searchsorted(sid, np.arange(grid) * T)
    ends = np.searchsorted(sid, np.arange(1, grid + 1) * T)
    W = max(8, int(np.ceil((ends - starts).max() / 8) * 8))
    E_pad = ((E + W - 1) // W + 2) * W
    sid_p = np.full((E_pad, 1), -1, np.int32)
    sid_p[:E, 0] = sid
    con_p = np.zeros((E_pad, C), np.float32)
    con_p[:E] = contrib
    bblk = (starts // W).astype(np.int32)
    ref = scatter_matmul(
        jnp.asarray(bblk), jnp.asarray(sid_p), jnp.asarray(con_p), S_pad, T, W, interpret=True
    )
    plan = slot_plan(sid, S_pad)
    out = slot_reduce(_t(contrib), _t(plan.perm), _t(plan.offsets), S_pad)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("sorted_dest", [True, False])
@pytest.mark.parametrize("C", [36, 6])
def test_slot_reduce_plain_matches_add_at(sorted_dest, C):
    rng = np.random.default_rng(C)
    n_slots, E = 300, 1000
    dest = rng.integers(0, n_slots, E)
    if sorted_dest:
        dest = np.sort(dest)
    contrib = rng.normal(size=(E, C))
    plan = slot_plan(dest, n_slots)
    out = slot_reduce(_t(contrib), _t(plan.perm), _t(plan.offsets), n_slots)
    ref = np.zeros((n_slots, C))
    np.add.at(ref, dest, contrib)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)


def test_slot_plan_is_stable_sort():
    dest = np.array([2, 0, 2, 1, 0, 2])
    plan = slot_plan(dest, 4)
    np.testing.assert_array_equal(plan.perm, [1, 4, 3, 0, 2, 5])
    np.testing.assert_array_equal(plan.offsets, [0, 2, 3, 6, 6])
    with pytest.raises(ValueError):
        slot_plan(np.array([0, 4]), 4)


# --------------------------------------------------------------------------
# Wrapper dispatch and checks
# --------------------------------------------------------------------------


def test_cpu_tensors_run_the_plain_versions():
    cuda_ops.reset_launches()
    He, cols, x = _random_ell(8, 3, 6, seed=1)
    ell_matvec(_t(He), _t(cols), _t(x))
    plan = slot_plan(np.array([0, 1, 1]), 2)
    slot_reduce(torch.ones(3, 36, dtype=torch.float64), _t(plan.perm), _t(plan.offsets), 2)
    assert cuda_ops.LAUNCHES == {
        "ell_matvec": 0, "ell_matvec_plain": 1, "ell_pcg": 0, "ell_pcg_plain": 0,
        "slot_reduce": 0, "slot_reduce_plain": 1, "ell_assemble": 0, "ell_assemble_plain": 0,
    }
    # ell_pcg's plain version is the host loop over the plain product: one
    # product for r0 and one per iteration
    He_t = _t(He)
    He_t[:, 0] += 50.0 * torch.eye(6, dtype=torch.float64)
    res = cuda_ops.ell_pcg(He_t, _t(cols), torch.linalg.inv(He_t[:, 0]).contiguous(), _t(x), 1e-6, 3)
    assert cuda_ops.LAUNCHES["ell_pcg_plain"] == 1 and cuda_ops.LAUNCHES["ell_pcg"] == 0
    assert cuda_ops.LAUNCHES["ell_matvec_plain"] == 2 + int(res.iterations)
    assert cuda_ops.pcg_iterations() == 0  # the device counter belongs to the kernel


@pytest.mark.parametrize(
    "case", ["cols_int64", "x_float32", "He_noncontiguous", "x_wrong_length", "He_int"]
)
def test_ell_matvec_rejects_bad_inputs(case):
    He, cols, x = (_t(a) for a in _random_ell(8, 3, 6, seed=2))
    if case == "cols_int64":
        cols = cols.long()
    elif case == "x_float32":
        x = x.float()
    elif case == "He_noncontiguous":
        He = He.transpose(2, 3)
    elif case == "x_wrong_length":
        x = x[:-1]
    else:
        He = He.long()
    with pytest.raises((TypeError, ValueError)):
        ell_matvec(He, cols, x)


@pytest.mark.parametrize("case", ["perm_int64", "offsets_length", "contrib_1d", "contrib_half"])
def test_slot_reduce_rejects_bad_inputs(case):
    plan = slot_plan(np.array([0, 1, 1]), 2)
    contrib, perm, offsets = torch.ones(3, 6, dtype=torch.float64), _t(plan.perm), _t(plan.offsets)
    n_slots = 2
    if case == "perm_int64":
        perm = perm.long()
    elif case == "offsets_length":
        n_slots = 3
    elif case == "contrib_1d":
        contrib = contrib[:, 0]
    else:
        contrib = contrib.half()
    with pytest.raises((TypeError, ValueError)):
        slot_reduce(contrib, perm, offsets, n_slots)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _ext._nvcc()
