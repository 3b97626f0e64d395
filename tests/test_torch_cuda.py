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

import dataclasses

import numpy as np
import pytest
import torch

from pyslam_tpu_torch.graph import FactorBatch, FactorGraph, build
from pyslam_tpu_torch.io import synth
from pyslam_tpu_torch.losses import CauchyLoss, HuberLoss, L1Loss, L2Loss, TDistributionLoss, TukeyLoss
from pyslam_tpu_torch import solver
from pyslam_tpu_torch.solver import assemble, bcsr, cuda_ops, linear, lm, schur, schur_sparse, sparse_chol
from pyslam_tpu_torch.solver.cuda_ops import (
    ell_assemble,
    ell_assemble_plain,
    ell_matvec,
    ell_matvec_plain,
    ell_pcg,
    ell_pcg_plain,
    slot_reduce,
    slot_reduce_plain,
)
from pyslam_tpu_torch.solver.lm import Options
from pyslam_tpu_torch.testing import se3_pair_graph, se3_stress_graph

from torch_support import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, sequential_slot_sum, slot_reduce_model, tiled_slot_sum)

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
@pytest.mark.parametrize("nb,n_x,K,d", [(1250, 2500, 9, 6), (300, 1000, 5, 3), (1, 40, 3, 6), (0, 8, 2, 6)])
def test_ell_matvec_kernel_takes_a_longer_x(cuda_device, nb, n_x, K, d, dtype):
    """The rows of one rank of a sharded solve against the x of every rank
    (``dist/pose_sharded.py``): cols in [0, n_x), x of n_x * d entries."""
    rng = np.random.default_rng(nb + n_x)
    He = torch.from_numpy(rng.normal(size=(nb, K, d, d))).to(cuda_device, dtype)
    cols = torch.from_numpy(rng.integers(0, n_x, size=(nb, K)).astype(np.int32)).to(cuda_device)
    x = torch.from_numpy(rng.normal(size=n_x * d)).to(cuda_device, dtype)
    cuda_ops.reset_launches()
    out = ell_matvec(He, cols, x)
    ref = ell_matvec_plain(He, cols, x)
    torch.cuda.synchronize()
    assert out.shape == (nb * d,) and cuda_ops.LAUNCHES["ell_matvec"] == 1
    if nb:
        _assert_close(out, ref, KERNEL_TOL[dtype])


# the sphere2500 shapes, widths of every copy unit (16, 8, 4 bytes), a plan
# with long segments and many empty ones, E = 0
SLOT_SHAPES = [
    (22500, 19792, 36), (2500, 9896, 6), (3500, 7814, 9), (3500, 7814, 3), (400, 1620, 49), (400, 820, 7),
    (300, 1000, 5), (1000, 40, 36), (7, 900, 36), (7, 900, 9), (10, 0, 36), (10, 0, 5),
    # few destinations of many rows (the Schur sums of bench config 4 by
    # camera), one destination, rows wider than a slab (600, 1500), the
    # largest grid
    (49, 25769, 36), (49, 25769, 6), (1, 5000, 3), (3, 2000, 5), (2, 700, 600), (2, 300, 1500), (1024, 70000, 9),
]


def _check_tiled(out, contrib, perm, offsets, n_slots):
    """``out``, a call without the plan's longest segment, has the bits of
    the unit kernel's order (``tiled_slot_sum``), and where every segment
    has at most ``SLOT_SEQ_ROWS`` rows, those of the sequential sum.  Then
    the call with it, as the package's plans make it: the plain version's
    sums, the same bits twice, the bits of its body's order
    (``slot_reduce_model``: the sequential sum where the body is
    sub-warps), one launch a call."""
    model = tiled_slot_sum(contrib, perm, offsets, n_slots, cuda_ops.SLOT_TILE_ROWS, cuda_ops.SLOT_SEQ_ROWS)
    assert torch.equal(out.cpu(), model)
    n = offsets[1:] - offsets[:-1]
    if n_slots and int(n.max()) <= cuda_ops.SLOT_SEQ_ROWS:
        assert torch.equal(model, sequential_slot_sum(contrib, perm, offsets, n_slots))
    longest = int(n.max()) if n_slots else 0
    n0 = cuda_ops.LAUNCHES["slot_reduce"]
    by_body = slot_reduce(contrib, perm, offsets, n_slots, longest)
    assert torch.equal(by_body, slot_reduce(contrib, perm, offsets, n_slots, longest))
    assert cuda_ops.LAUNCHES["slot_reduce"] == n0 + (2 if n_slots * contrib.shape[1] else 0)
    if contrib.shape[0]:
        _assert_close(by_body, slot_reduce_plain(contrib, perm, offsets, n_slots), KERNEL_TOL[contrib.dtype])
    model = slot_reduce_model(contrib, perm, offsets, n_slots, longest)
    assert torch.equal(by_body.cpu(), model)
    if cuda_ops.slot_reduce_body(contrib.shape[0], n_slots, contrib.shape[1], longest) == "subwarps":
        assert torch.equal(model, sequential_slot_sum(contrib, perm, offsets, n_slots))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_slots,E,C", SLOT_SHAPES)
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
    assert torch.equal(out, again)  # no atomics on values: the same bits every run
    if E:
        _assert_close(out, ref, KERNEL_TOL[dtype])
        _check_tiled(out, contrib, perm, offsets, n_slots)
    else:
        assert not out.any()


# Past 1,024 destinations of many rows each: the sums of bench config 6 by
# camera (1,700 destinations, about 2,736 rows each, cut to 300 here) at
# the widths of a linearization, of D and of a Schur product, and by
# landmark (about 4.65 rows each) at the widths 9 and 3.
VENICE_SLOT_SHAPES = [(1700, 1700 * 300, 27), (1700, 1700 * 300, 21), (1700, 1700 * 300, 6),
                      (2048, 2048 * 70, 6), (200_000, 930_000, 9), (200_000, 930_000, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_slots,E,C", VENICE_SLOT_SHAPES)
def test_slot_reduce_both_kernels_past_1024_destinations(cuda_device, n_slots, E, C, dtype):
    """The kernel against the plain version, bit for bit across two runs
    and against the host model of its order."""
    rng = np.random.default_rng(7)
    plan = bcsr.slot_plan(rng.integers(0, n_slots, E), n_slots)
    contrib = torch.from_numpy(rng.normal(size=(E, C))).to(cuda_device, dtype)
    perm = torch.from_numpy(plan.perm).to(cuda_device)
    offsets = torch.from_numpy(plan.offsets).to(cuda_device)
    out = slot_reduce(contrib, perm, offsets, n_slots)
    assert torch.equal(out, slot_reduce(contrib, perm, offsets, n_slots))
    _assert_close(out, slot_reduce_plain(contrib, perm, offsets, n_slots), KERNEL_TOL[dtype])
    _check_tiled(out, contrib, perm, offsets, n_slots)


def _skewed_sizes(kind, R, S):
    """Rows per destination of a skewed plan: one destination of 20,000
    rows among 4,000 of 1 to 5; destinations of S - 1, S, S + 1, R - 1, R
    and R + 1 rows (and twice and three times R, around the chunk cuts)
    among short ones; Zipf-distributed rows, as the pair plans of bench
    config 6 have them."""
    rng = np.random.default_rng(11)
    if kind == "one_long":
        sizes = np.concatenate([[20_000], rng.integers(1, 6, 4000)])
    elif kind == "around_R":
        sizes = np.concatenate([[S - 1, S, S + 1, R - 1, R, R + 1, 2 * R - 1, 2 * R, 2 * R + 1, 3 * R],
                                rng.integers(0, 4, 500)])
    else:
        sizes = np.minimum(rng.zipf(1.4, 3000), 18_576)
    rng.shuffle(sizes)
    return sizes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [36, 21, 27, 81])
@pytest.mark.parametrize("kind", ["one_long", "around_R", "zipf"])
def test_slot_reduce_kernel_on_skewed_plans(cuda_device, kind, C, dtype):
    """Skewed plans: the plain version's sums, the same bits on a second
    run and the host model's bits (``tiled_slot_sum``), one launch a
    call."""
    sizes = _skewed_sizes(kind, cuda_ops.SLOT_TILE_ROWS, cuda_ops.SLOT_SEQ_ROWS)
    n_slots = len(sizes)
    rng = np.random.default_rng(12)
    dest = np.repeat(np.arange(n_slots), sizes)
    rng.shuffle(dest)
    plan = bcsr.slot_plan(dest, n_slots)
    contrib = torch.from_numpy(rng.normal(size=(len(dest), C))).to(cuda_device, dtype)
    perm, offsets = torch.from_numpy(plan.perm).to(cuda_device), torch.from_numpy(plan.offsets).to(cuda_device)
    cuda_ops.reset_launches()
    out = slot_reduce(contrib, perm, offsets, n_slots)
    again = slot_reduce(contrib, perm, offsets, n_slots)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["slot_reduce"] == 2 and torch.equal(out, again)
    _assert_close(out, slot_reduce_plain(contrib, perm, offsets, n_slots), KERNEL_TOL[dtype])
    _check_tiled(out, contrib, perm, offsets, n_slots)


def _landmark_sizes(n_slots, seed):
    """Rows per destination of a sum by landmark, cut down from BAL's: a
    power law of track lengths, most of 2 or 3 rows, and a few tracks past
    SLOT_TILE_ROWS up to Venice's longest, 1,765."""
    rng = np.random.default_rng(seed)
    sizes = np.minimum(1 + rng.zipf(2.0, n_slots), 1765)
    sizes[rng.choice(n_slots, 4, replace=False)] = [300, 700, 1200, 1765]
    return sizes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [3, 9])
def test_slot_reduce_takes_the_tiles_on_a_skewed_landmark_plan(cuda_device, C, dtype):
    """A skewed plan of many destinations (40,000 landmarks, most of 2 or
    3 rows, a few past SLOT_TILE_ROWS) whose longest chain a block would
    take: with its ``longest``, the tiles sum it, one launch a call counted
    by the body and in the total, the same bits twice and the host model's,
    the plain version's sums."""
    sizes = _landmark_sizes(40_000, 13)
    n_slots, E = len(sizes), int(sizes.sum())
    longest = int(sizes.max())
    assert longest > cuda_ops.SLOT_TILE_ROWS and cuda_ops.slot_block_depth(longest, C) <= cuda_ops.SLOT_BLOCK_DEPTH
    assert int(np.median(sizes)) <= 3
    assert cuda_ops.slot_reduce_body(E, n_slots, C, longest) == "tiles"
    rng = np.random.default_rng(14)
    dest = np.repeat(np.arange(n_slots), sizes)
    rng.shuffle(dest)  # the observations in another order than the landmarks': a gather
    plan = bcsr.slot_plan(dest, n_slots)
    assert plan.longest == longest
    contrib = torch.from_numpy(rng.normal(size=(E, C))).to(cuda_device, dtype)
    perm, offsets = torch.from_numpy(plan.perm).to(cuda_device), torch.from_numpy(plan.offsets).to(cuda_device)
    cuda_ops.reset_launches()
    out = slot_reduce(contrib, perm, offsets, n_slots, longest)
    assert cuda_ops.LAUNCHES["slot_reduce"] == 1 and cuda_ops.LAUNCHES["slot_reduce.tiles"] == 1
    again = slot_reduce(contrib, perm, offsets, n_slots, longest)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["slot_reduce"] == 2 and cuda_ops.LAUNCHES["slot_reduce.tiles"] == 2
    assert cuda_ops.LAUNCHES["slot_reduce.block"] == 0 and cuda_ops.LAUNCHES["slot_reduce.subwarps"] == 0
    assert torch.equal(out, again)
    _assert_close(out, slot_reduce_plain(contrib, perm, offsets, n_slots), KERNEL_TOL[dtype])
    assert torch.equal(out.cpu(), slot_reduce_model(contrib, perm, offsets, n_slots, longest))


@pytest.mark.parametrize("body,n_slots,rows,longest", [("subwarps", 3000, 3, 40), ("block", 20, 450, 700),
                                                      ("block", 100, 2, 1080), ("tiles", 400, 2, 1700)])
def test_slot_reduce_counts_launches_by_body(cuda_device, body, n_slots, rows, longest):
    """Each launch counts once in the total and once under the body that
    ``slot_reduce_body`` gives its plan."""
    rng = np.random.default_rng(15)
    sizes = np.full(n_slots, rows)
    sizes[0] = longest
    E = int(sizes.sum())
    dest = np.repeat(np.arange(n_slots), sizes)
    rng.shuffle(dest)
    plan = bcsr.slot_plan(dest, n_slots)
    assert cuda_ops.slot_reduce_body(E, n_slots, 6, plan.longest) == body
    contrib = torch.from_numpy(rng.normal(size=(E, 6))).to(cuda_device, torch.float32)
    perm, offsets = torch.from_numpy(plan.perm).to(cuda_device), torch.from_numpy(plan.offsets).to(cuda_device)
    cuda_ops.reset_launches()
    for calls in (1, 2, 3):
        out = slot_reduce(contrib, perm, offsets, n_slots, plan.longest)
        assert cuda_ops.LAUNCHES["slot_reduce"] == calls and cuda_ops.LAUNCHES[f"slot_reduce.{body}"] == calls
    assert sum(cuda_ops.LAUNCHES[f"slot_reduce.{b}"] for b in ("tiles", "subwarps", "block")) == 3
    _assert_close(out, slot_reduce_plain(contrib, perm, offsets, n_slots), KERNEL_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [36, 81, 1500])
def test_slot_reduce_kernel_takes_an_unaligned_view(cuda_device, C, dtype):
    """A contiguous view that starts off the 16-byte grid takes copies of
    the value's own size (4 or 8 bytes) and gives the same bits, also past
    a chunk cut."""
    rng = np.random.default_rng(6)
    sizes = np.concatenate([[700], rng.integers(0, 6, 50)])
    n_slots, E = len(sizes), int(sizes.sum())
    dest = np.repeat(np.arange(n_slots), sizes)
    rng.shuffle(dest)
    plan = bcsr.slot_plan(dest, n_slots)
    flat = torch.from_numpy(rng.normal(size=E * C + 1)).to(cuda_device, dtype)
    perm, offsets = torch.from_numpy(plan.perm).to(cuda_device), torch.from_numpy(plan.offsets).to(cuda_device)
    view = flat[1:].reshape(E, C)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert cuda_ops.slot_reduce_layout(E, C, view.element_size(), view.data_ptr())[0] == view.element_size()
    out = slot_reduce(view, perm, offsets, n_slots)
    assert torch.equal(out, slot_reduce(view.clone(), perm, offsets, n_slots))
    _check_tiled(out, view, perm, offsets, n_slots)


# --------------------------------------------------------------------------
# ell_assemble
# --------------------------------------------------------------------------

ASSEMBLE_LOSSES = {
    "l2": L2Loss(), "l1": L1Loss(), "cauchy": CauchyLoss(2.0), "huber": HuberLoss(1.0), "tukey": TukeyLoss(3.0),
    "student_t": TDistributionLoss(5.0, 1.5),
}
# ell_assemble against ell_assemble_plain, relative to the largest entry of
# He, of g, and to chi2.  f64: rounding only.  f32: the kernel contracts
# multiply-adds and sums in another order than the batched tensor code; the
# error of a Jacobian entry is a few f32 roundings of the largest
# intermediate, and He squares the Jacobians.
ASSEMBLE_TOL = {torch.float32: 2e-5, torch.float64: 1e-11}
# L1's weight 1 / |e| carries the relative rounding error of e, which is an
# f32 rounding of the residual's largest term over |e|: the stress graph has
# residual elements of 1e-4 beside terms of order one, and the entry of He
# they weigh is its largest.
L1_F32_TOL = 5e-3


def _assemble_args(g, device):
    return bcsr.ell_assemble_args(g, bcsr.ell_device_plan(bcsr.build_ell_direct(g), device))


def _check_assemble(args, dtype, tol=None):
    tol = ASSEMBLE_TOL[dtype] if tol is None else tol
    cuda_ops.reset_launches()
    out = ell_assemble(*args)
    again = ell_assemble(*args)
    ref = ell_assemble_plain(*args)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["ell_assemble"] == 2
    for name, a, b, r in zip(("He", "g", "chi2"), out, again, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), name  # ordered sums, no atomics: the same bits every run
        err = (a - r).abs().max().item()
        assert err <= tol * r.abs().max().item(), (name, err, r.abs().max().item())
    return out


def _assert_halves_transposed(He, cols):
    """Every stored off-diagonal block is the transpose of its partner in
    the other pose's row, bit for bit."""
    nb, K = cols.shape
    c = cols.long()
    r = torch.arange(nb, device=c.device)[:, None].expand(nb, K)
    back = c[c] == r[..., None]  # (nb, K, K): row c[r, k] names r at slot k'
    rr, kk = torch.nonzero(c != r, as_tuple=True)
    assert len(rr) and (back[rr, kk].sum(-1) == 1).all()
    partner = back[rr, kk].int().argmax(-1)
    assert torch.equal(He[rr, kk], He[c[rr, kk], partner].transpose(-1, -2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_poses", [60, 2500, 30000])
def test_ell_assemble_kernel_matches_plain_on_spheres(cuda_device, n_poses, dtype):
    g = build.pose_graph(synth.se3_sphere(n_poses=n_poses, seed=3), dtype=dtype, device=cuda_device)
    args = _assemble_args(g, cuda_device)
    He, gvec, _ = _check_assemble(args, dtype)
    assert He.shape[0] == n_poses and gvec.shape == (n_poses * 6,)
    _assert_halves_transposed(He, args[3])
    # pose 0 is the anchor: identity at slot 0, zero elsewhere in its row, zero gradient
    assert torch.equal(He[0, 0], torch.eye(6, dtype=dtype, device=cuda_device))
    assert not He[0, 1:].any() and not gvec[:6].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("loss", sorted(ASSEMBLE_LOSSES))
def test_ell_assemble_kernel_matches_plain_on_the_stress_graph(cuda_device, loss, dtype):
    """Special angles (0, below 1e-4, within 1e-3 of pi), priors, padding
    factors, a general sqrt_info, a frozen interior pose, every loss."""
    g = se3_stress_graph(loss=ASSEMBLE_LOSSES[loss], dtype=dtype, device=cuda_device)
    tol = L1_F32_TOL if (loss, dtype) == ("l1", torch.float32) else None
    args = _assemble_args(g, cuda_device)
    He, gvec, _ = _check_assemble(args, dtype, tol)
    _assert_halves_transposed(He, args[3])
    mid = He.shape[0] // 2
    cols = bcsr.build_ell_direct(g).cols
    for frozen in (0, mid):
        assert torch.equal(He[frozen, 0], torch.eye(6, dtype=dtype, device=cuda_device))
        assert not He[frozen, 1:].any() and not gvec[6 * frozen : 6 * frozen + 6].any()
    # the frozen pose's column is zero in its neighbours' rows
    r, k = np.nonzero((cols == mid) & (np.arange(len(cols))[:, None] != mid))
    assert len(r) and not He[r, k].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_assemble_kernel_matches_plain_where_factors_share_pairs(cuda_device, dtype):
    """Slots that sum several factors of one pose pair (one batch both ways,
    two batches), priors beside betweens: the row tables' order."""
    g = se3_pair_graph(loss=CauchyLoss(2.0), dtype=dtype, device=cuda_device)
    He, _, _ = _check_assemble(_assemble_args(g, cuda_device), dtype)
    assert torch.equal(He[0, 0], torch.eye(6, dtype=dtype, device=cuda_device))


def test_ell_assemble_kernel_general_route_agrees(cuda_device):
    """The kernel against the route it replaces on the card (plain-tensor
    linearization + two slot_reduce), f64."""
    g = se3_stress_graph(loss=CauchyLoss(2.0), device=cuda_device)
    dplan = bcsr.ell_device_plan(bcsr.build_ell_direct(g), cuda_device)
    cuda_ops.reset_launches()
    out = bcsr.assemble_ell(g, dplan)
    ref = bcsr.assemble_ell_general(g, dplan)
    assert cuda_ops.LAUNCHES["ell_assemble"] == 1 and cuda_ops.LAUNCHES["slot_reduce"] == 2
    assert not any(n for k, n in cuda_ops.LAUNCHES.items() if k.endswith("_plain"))
    for a, r in zip(out, ref):
        _assert_close(a, r, 1e-11)


def _padded(g, pad_poses):
    """``g`` with zero-weight self-loop ``between_se3`` factors appended to
    its batch, padded as the reference's ``test_padding_inert`` pads: the
    batch's first measurements again, on the poses (i, i) of ``pad_poses``."""
    (fb,) = g.batches
    n = len(pad_poses)
    at = torch.tensor(pad_poses, dtype=fb.indices[0].dtype, device=fb.weight.device)
    return FactorGraph(g.blocks, [dataclasses.replace(
        fb, indices=tuple(torch.cat([i, at]) for i in fb.indices),
        data={k: torch.cat([v, v[:n]]) for k, v in fb.data.items()},
        weight=torch.cat([fb.weight, fb.weight.new_zeros(n)]))])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pad_poses", [(0,), (17,), (0, 17, 17, 42, 0)], ids=["anchor", "free", "several"])
def test_ell_assemble_zero_weight_self_loops_are_inert(cuda_device, pad_poses, dtype):
    """Zero-weight self-loops on the frozen pose 0 and on free poses: the
    row tables send their cross blocks to the diagonal slot (k = 0).  The
    kernel matches its plain version, and He, g and chi2 are the unpadded
    graph's, bit for bit; the padded factors' contributions are zero."""
    g = build.pose_graph(synth.se3_sphere(n_poses=60, seed=3), dtype=dtype, device=cuda_device)
    gp = _padded(g, pad_poses)
    plan, plan_p = bcsr.build_ell_direct(g), bcsr.build_ell_direct(gp)
    assert np.array_equal(plan_p.cols, plan.cols)  # a self-loop adds no column
    args_p = _assemble_args(gp, cuda_device)
    out = _check_assemble(args_p, dtype)
    ref = ell_assemble(*_assemble_args(g, cuda_device))
    for name, a, r in zip(("He", "g", "chi2"), out, ref):
        assert torch.equal(a, r), name
    h, gc, _ = bcsr.ell_contributions(gp, plan_p)
    F = g.batches[0].n + len(pad_poses)
    assert not h.view(-1, F, h.shape[-1])[:, -len(pad_poses):].any()
    assert not gc.view(-1, F, gc.shape[-1])[:, -len(pad_poses):].any()


def test_ell_assemble_refuses_mixed_devices(cuda_device):
    args = list(_assemble_args(se3_stress_graph(device=cuda_device), cuda_device))
    args[3] = args[3].cpu()
    with pytest.raises(ValueError, match="different devices"):
        ell_assemble(*args)


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


# the last is past what shared memory holds (38.9 MB of He in f32); d = 9
# and 4 are the chordal rotation stages of sphere2500 and of an M3500-class
# SE(2) graph, on the generic template
PCG_SHAPES = [(2500, 9, 6), (300, 5, 3), (1, 1, 6), (30000, 9, 6), (2500, 9, 9), (3500, 7, 4)]


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
@pytest.mark.parametrize("nb,K,d", [(2500, 9, 6), (30000, 9, 6), (2500, 9, 9), (3500, 7, 4)])
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


def _pcg_columns(b, m, seed=5):
    """m right-hand sides that stop at different iterations: b, unit vectors
    (covariance columns), a zero column, random ones."""
    n = b.shape[0]
    gen = torch.Generator(device=b.device).manual_seed(seed)
    B = torch.randn((n, m), generator=gen, device=b.device, dtype=b.dtype)
    B[:, 0] = b
    for j in range(1, min(m, 4)):
        B[:, j] = 0.0
        B[(j * 997) % n, j] = 1.0
    if m > 4:
        B[:, 4] = 0.0
    return B


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,K,d", [(2500, 9, 6), (300, 5, 3), (30000, 9, 6), (3500, 7, 4)])
@pytest.mark.parametrize("m", ["one", "mid", "max", "over"])
def test_ell_pcg_kernel_block_matches_plain(cuda_device, nb, K, d, dtype, m):
    """A block of right-hand sides: one launch per ``max_columns`` columns,
    no host read, each column against the plain version's (its iterations
    as ``PCG_TOL`` allows, x within its tolerance), the zero column stopped
    at once, two runs the same bits."""
    He, cols, Minv, b = _spd_ell(nb, K, d, 6, cuda_device, dtype)
    cap = cuda_ops.ell_pcg_plan(nb, K, d, dtype, cuda_device)["max_columns"]
    assert cap >= 1
    n_cols = {"one": 1, "mid": min(cap, 16), "max": cap, "over": 2 * cap + 3}[m]
    B = _pcg_columns(b, n_cols)
    rtol = PCG_RTOL[dtype]
    cuda_ops.reset_launches()
    linear.reset_host_reads()
    out = ell_pcg(He, cols, Minv, B, rtol, 200)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["ell_pcg"] == -(-n_cols // cap) and cuda_ops.LAUNCHES["ell_pcg_plain"] == 0
    assert linear.HOST_READS["pcg"] == 0
    assert out.x.shape == B.shape and out.iterations.shape == (n_cols,)
    ref = ell_pcg_plain(He, cols, Minv, B, rtol, 200)
    x_tol, it_tol = PCG_TOL[dtype]
    its, its_ref = out.iterations.tolist(), ref.iterations.tolist()
    assert cuda_ops.pcg_iterations() == sum(its)
    assert all(abs(a - r) <= it_tol for a, r in zip(its, its_ref)), (its, its_ref)
    if n_cols > 4:
        assert its[4] == 0 and not out.x[:, 4].any()
    for j in range(n_cols):
        if ref.x[:, j].any():
            _assert_close(out.x[:, j], ref.x[:, j], x_tol)
    again = ell_pcg(He, cols, Minv, B, rtol, 200)
    assert torch.equal(out.x, again.x) and torch.equal(out.iterations, again.iterations)
    # a column of the block is the single-column solve of that column
    one = ell_pcg(He, cols, Minv, B[:, 0].contiguous(), rtol, 200)
    assert abs(int(one.iterations) - its[0]) <= it_tol
    _assert_close(out.x[:, 0], one.x, x_tol)


def test_ell_pcg_plan_columns(cuda_device):
    """sphere2500's shapes keep He resident beside tens of columns, more in
    f32 than in f64; more columns than the plan's maximum are refused by the
    plan (the wrapper splits them)."""
    f32 = cuda_ops.ell_pcg_plan(2500, 9, 6, torch.float32, cuda_device)
    f64 = cuda_ops.ell_pcg_plan(2500, 9, 6, torch.float64, cuda_device)
    assert f32["max_columns"] > f64["max_columns"] >= 16
    full = cuda_ops.ell_pcg_plan(2500, 9, 6, torch.float64, cuda_device, f64["max_columns"])
    assert full["resident_rows"] == 2500
    with pytest.raises(RuntimeError, match="more columns"):
        cuda_ops.ell_pcg_plan(2500, 9, 6, torch.float64, cuda_device, f64["max_columns"] + 1)
    big = cuda_ops.ell_pcg_plan(30000, 9, 6, torch.float32, cuda_device)
    assert big["max_columns"] == 1 and 0 < big["resident_rows"] < 30000


def _launch_on(He, cols, Minv, B, rtol, max_iters, scratch):
    """One ``ell_pcg`` launch of B's columns on the caller's scratch: x
    (nb*d, m) and the iteration counts, queued on the current stream."""
    n, m = B.shape
    bk = B.new_zeros((n, cuda_ops.pcg_layout_columns(m, B.dtype)))
    bk[:, :m] = B
    xk = torch.empty_like(bk)
    its = torch.empty(m, dtype=torch.int32, device=B.device)
    cuda_ops.ell_pcg_launch(He, cols, Minv, bk, xk, scratch, its, rtol, max_iters)
    return xk[:, :m], its


def _scratch(He, m, cuda_device):
    nb, K, d, _ = He.shape
    grid = cuda_ops.ell_pcg_plan(nb, K, d, He.dtype, cuda_device, m)["grid"]
    n_values = cuda_ops.pcg_scratch_values(nb * d, cuda_ops.pcg_layout_columns(m, He.dtype), grid, He.dtype)
    return torch.empty(n_values, dtype=He.dtype, device=cuda_device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,K,d", [(2500, 9, 6), (2500, 9, 9), (3500, 7, 4), (30000, 9, 6)])
@pytest.mark.parametrize("m", ["one", "mid", "max"])
def test_ell_pcg_kernel_stale_scratch_same_bits(cuda_device, nb, K, d, dtype, m):
    """The carrying barriers' slots are cleared by every launch: scratch
    filled with 0x00, with 0xFF, left as a previous launch of the same
    shapes left it, or shared by two launches back to back on one stream,
    gives the bits of a launch on fresh scratch, x and counts; columns that
    stop at different iterations (b, unit columns, a zero column, random
    ones), m = 1, 12 and the plan's maximum (1 for the non-resident plan)."""
    He, cols, Minv, b = _spd_ell(nb, K, d, 6, cuda_device, dtype)
    cap = cuda_ops.ell_pcg_plan(nb, K, d, dtype, cuda_device)["max_columns"]
    n_cols = {"one": 1, "mid": min(12, cap), "max": cap}[m]
    B = _pcg_columns(b, n_cols)
    rtol = PCG_RTOL[dtype]
    fresh = ell_pcg(He, cols, Minv, B, rtol, 200)
    torch.cuda.synchronize()
    scratch = _scratch(He, n_cols, cuda_device)
    for fill in (0x00, 0xFF, None):  # None: the state the launch before left
        if fill is not None:
            scratch.view(torch.uint8).fill_(fill)
        x, its = _launch_on(He, cols, Minv, B, rtol, 200, scratch)
        torch.cuda.synchronize()
        assert torch.equal(x, fresh.x) and torch.equal(its, fresh.iterations), fill
    first = _launch_on(He, cols, Minv, B, rtol, 200, scratch)
    second = _launch_on(He, cols, Minv, B, rtol, 200, scratch)  # no synchronisation between
    torch.cuda.synchronize()
    for x, its in (first, second):
        assert torch.equal(x, fresh.x) and torch.equal(its, fresh.iterations)
    assert len(set(fresh.iterations.tolist())) > (1 if n_cols > 4 else 0)


def test_ell_pcg_barrier_probe_runs(cuda_device):
    """The measurement entry point of the barriers launches and sums what
    every block contributed: round r adds (blk + r) + 1 over the G blocks,
    alike for every kind."""
    from pyslam_tpu_torch._ext import library

    G = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    rounds = 10
    want = sum(G * (G - 1) / 2 + G * r + G for r in range(rounds))
    for dtype in (torch.float32, torch.float64):
        for kind in (0, 1, 2):
            scratch = torch.full((1 << 17,), float("nan"), dtype=dtype, device=cuda_device)
            out = torch.zeros(1, dtype=dtype, device=cuda_device)
            err = library().pyslam_ell_pcg_barrier_probe(
                out.element_size(), kind, rounds, scratch.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(cuda_device).cuda_stream)
            assert err == 0
            torch.cuda.synchronize()
            assert out.item() == want, (dtype, kind)


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
    # and every assembly (one before the loop, one per trial point) is one ell_assemble
    assert launches["ell_pcg"] == i_gpu.iterations and launches["ell_assemble"] == i_gpu.iterations + 1
    assert launches["slot_reduce"] == 0
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


# --------------------------------------------------------------------------
# The Schur path (bundle adjustment, landmark SLAM): slot_reduce at its shapes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_slots,C", [(49, 36), (7000, 9), (5, 6), (0, 36), (0, 5), (3, 0)])
def test_slot_reduce_with_zero_contributions(cuda_device, n_slots, C, dtype):
    """No contribution at all (a graph without (pose, pose) factors, or
    without observations): every slot is 0; with no slot, or no column,
    there is nothing to launch and nothing is counted."""
    contrib = torch.zeros((0, C), dtype=dtype, device=cuda_device)
    perm = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    offsets = torch.zeros(n_slots + 1, dtype=torch.int32, device=cuda_device)
    cuda_ops.reset_launches()
    out = slot_reduce(contrib, perm, offsets, n_slots)
    torch.cuda.synchronize()
    assert out.shape == (n_slots, C) and out.dtype == dtype and not out.any()
    assert cuda_ops.LAUNCHES["slot_reduce"] == (1 if n_slots * C else 0)
    assert cuda_ops.LAUNCHES["slot_reduce_plain"] == 0


def _config4(dtype, device):
    return build.ba_graph(synth.ba_synthetic(n_cams=49, n_pts=7000, seed=0), dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ba_assemble_of_config4_repeats_bit_for_bit(cuda_device, dtype):
    """Two assemblies of bench config 4 (49 cameras, 7,000 points) on the
    card give the same bits, every sum through the ``slot_reduce`` kernel,
    and agree with the CPU path (``slot_reduce_plain``) to the kernel's
    tolerance."""
    g = _config4(dtype, cuda_device)
    plan = schur.schur_plan(g)
    cuda_ops.reset_launches()
    parts, grad, chi2 = schur.ba_assemble(g, plan=plan)
    again, grad_again, chi2_again = schur.ba_assemble(g)  # a plan of its own
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["slot_reduce"] == 8 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    for k in ("Hpp", "Hll", "W", "PP", "g_p", "g_l"):
        assert torch.equal(parts[k], again[k]), k
    assert torch.equal(grad, grad_again) and torch.equal(chi2, chi2_again)
    ref, grad_ref, chi2_ref = schur.ba_assemble(_config4(dtype, "cpu"))
    # the linearization itself differs between the two devices in f32 (other
    # fused multiply-adds): ten times the kernel's tolerance
    rel = 10 * KERNEL_TOL[dtype]
    for k in ("Hpp", "Hll", "W", "g_p", "g_l"):
        _assert_close(parts[k].cpu(), ref[k], rel)
    _assert_close(grad.cpu(), grad_ref, rel)
    assert abs(chi2.item() - chi2_ref.item()) <= rel * chi2_ref.item()


def _priors_only(device):
    """A camera / landmark graph with no observation and no (pose, pose)
    factor: W and PP are empty, and so is every sum over them."""
    g = build.ba_graph(synth.ba_synthetic(n_cams=4, n_pts=12, seed=0), dtype=torch.float64, device=device)
    poses, pts = g.blocks["poses"].values, g.blocks["landmarks"].values
    eye = torch.eye(6, dtype=torch.float64, device=poses.device)
    batches = [
        FactorBatch.create("prior_se3", ("poses",), (np.arange(4),),
                           {"T_obs": poses.flip(0).contiguous(), "sqrt_info": eye.expand(4, 6, 6).contiguous()},
                           loss=L2Loss()),
        FactorBatch.create("prior_euclidean", ("landmarks",), (np.arange(12),),
                           {"obs": pts + 0.1, "sqrt_info": 2.0 * eye[:3, :3]}, loss=L2Loss()),
    ]
    return FactorGraph(g.blocks, batches)


SCHUR_GRAPHS = {
    "ba": lambda device: build.ba_graph(synth.ba_synthetic(n_cams=8, n_pts=60, seed=3), dtype=torch.float64,
                                        device=device),
    "landmark_slam_2d": lambda device: build.landmark_slam_2d(
        synth.landmark_slam_2d(n_poses=40, n_landmarks=25, obs_type="xy", seed=3), dtype=torch.float64,
        device=device),
    "priors_only": _priors_only,
}


@pytest.mark.parametrize("mode", ["dense", "pcg"])
@pytest.mark.parametrize("name", sorted(SCHUR_GRAPHS))
def test_solve_schur_on_the_card_matches_the_cpu_path(cuda_device, name, mode):
    opts = Options(method="lm", max_iters=25)
    s_c, i_c = schur.solve_schur(SCHUR_GRAPHS[name]("cpu"), opts, mode=mode)
    cuda_ops.reset_launches()
    s_g, i_g = schur.solve_schur(SCHUR_GRAPHS[name](cuda_device), opts, mode=mode)
    assert cuda_ops.LAUNCHES["slot_reduce"] > 0 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    assert (i_g.iterations, i_g.status) == (i_c.iterations, i_c.status)
    assert i_g.accepted.cpu().tolist() == i_c.accepted.tolist()
    assert abs(i_g.chi2.item() - i_c.chi2.item()) <= 1e-9 * i_c.chi2.item()
    for n in s_c.blocks:
        assert (s_g.blocks[n].values.cpu() - s_c.blocks[n].values).abs().max().item() <= 1e-6


@pytest.mark.parametrize("linear", ["pcg", "dense"])
def test_solve_schur_large_on_the_card_matches_the_cpu_path(cuda_device, linear):
    from pyslam_tpu_torch.solver import schur_large

    data = synth.ba_synthetic(n_cams=8, n_pts=64, seed=3)
    opts = Options(method="lm", max_iters=12)
    s_c, c_c, h_c = schur_large.solve_schur_large(build.ba_graph(data, dtype=torch.float64, device="cpu"), opts,
                                                  n_chunks=4, linear=linear)
    cuda_ops.reset_launches()
    g = build.ba_graph(data, dtype=torch.float64, device=cuda_device)
    s_g, c_g, h_g = schur_large.solve_schur_large(g, opts, n_chunks=4, linear=linear)
    again = schur_large.solve_schur_large(g, opts, n_chunks=4, linear=linear)
    assert cuda_ops.LAUNCHES["slot_reduce"] > 0 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    assert len(h_g) == len(h_c) and h_g[-1] < h_g[0]
    np.testing.assert_allclose(h_g, h_c, rtol=1e-9)
    assert again[2] == h_g and torch.equal(again[0].blocks["poses"].values, s_g.blocks["poses"].values)
    for n in s_c.blocks:
        assert (s_g.blocks[n].values.cpu() - s_c.blocks[n].values).abs().max().item() <= 1e-8


# --------------------------------------------------------------------------
# bal_rows: the BAL observations' rows of schur_large in one launch
# --------------------------------------------------------------------------

# bal_rows against bal_rows_plain, each column relative to the largest sum
# of the magnitudes of its terms (``cuda_ops.bal_rows_scale``: an entry
# that cancels keeps the rounding of its terms).  f64: rounding only.  f32: the kernel
# contracts multiply-adds where the twin rounds apart, so a residual differs
# by a few f32 roundings of the prediction (hundreds of px) beside residuals
# of at least 0.75 px, and a robust weight amplifies that by e w'(e) / w
# (Cauchy's and Tukey's reach 5e-4 of the scale against an f64 twin on
# 200,001 observations, measured on the CPU; the kernel and the f32 twin
# each err so).
BAL_TOL = {torch.float32: 2e-3, torch.float64: 1e-10}
# The 9-dof instantiation's: its intrinsics columns (f r2 pn, f r2^2 pn) are
# rounded the same way, and the f32 twin alone reaches 1.09e-3 of the scale
# against the f64 twin under Cauchy at 200,001 observations (measured on the
# CPU); the kernel and the twin each err so, so their difference is held to
# twice that with room.
BAL9_TOL = {torch.float32: 4e-3, torch.float64: 1e-10}


def _bal_rows_args(M, dtype, device, per_obs_info, seed=0):
    """``bal_rows``' arguments for M observations of a ``synthetic_bal``
    scene (f, k1, k2 an observation), its cameras and points perturbed,
    random weights in [0.5, 2] and, with ``per_obs_info``, one sqrt_info an
    observation (a diagonal in [0.5, 1.5], off-diagonal entries within
    0.05): the observations put each residual element 2 to 5 px from the
    prediction, so that |r| >= 0.75 px."""
    from pyslam_tpu_torch.graph.core import FACTOR_KERNELS
    from pyslam_tpu_torch.io import bal

    data = bal.perturbed(bal.synthetic_bal(n_cams=12, n_pts=max(-(-M // 4), 1), seed=seed), seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    cam, pt = data.cam_idx[:M].astype(np.int64), data.pt_idx[:M].astype(np.int64)
    intr = np.asarray(data.intrinsics)[cam]
    poses, lms = torch.from_numpy(data.T), torch.from_numpy(data.pts)
    f, k1, k2 = (torch.from_numpy(np.ascontiguousarray(intr[:, i])) for i in range(3))
    pred, _ = FACTOR_KERNELS["reprojection_bal"](
        {"obs": torch.zeros(M, 2, dtype=torch.float64), "sqrt_info": torch.eye(2, dtype=torch.float64),
         "f": f, "k1": k1, "k2": k2}, poses[cam], lms[pt], compute_jacobians=False)
    off = rng.uniform(2.0, 5.0, size=(M, 2)) * rng.choice([-1.0, 1.0], size=(M, 2))
    obs = pred + torch.from_numpy(off)
    if per_obs_info:
        info = np.zeros((M, 2, 2))
        info[:, [0, 1], [0, 1]] = rng.uniform(0.5, 1.5, size=(M, 2))
        info[:, [0, 1], [1, 0]] = rng.uniform(-0.05, 0.05, size=(M, 2))
        info = torch.from_numpy(info)
    else:
        info = torch.tensor([[1.2, 0.03], [-0.02, 0.8]], dtype=torch.float64)
    weight = torch.from_numpy(rng.uniform(0.5, 2.0, size=M))
    args = (poses, lms, torch.from_numpy(cam), torch.from_numpy(pt), obs, f, k1, k2, info, weight)
    return tuple(a.to(device, dtype).contiguous() if a.is_floating_point() else a.to(device) for a in args)


def _check_bal_rows(args, loss, tol):
    """The kernel against its twin on the card (cost and rows), two launches
    bitwise equal, the cost-only launch's cost within the tolerance."""
    cuda_ops.reset_launches()
    cost, rows = cuda_ops.bal_rows(*args, loss)
    again = cuda_ops.bal_rows(*args, loss)
    only, none = cuda_ops.bal_rows(*args, loss, rows=False)
    ref = cuda_ops.bal_rows_plain(*args, loss)
    torch.cuda.synchronize()
    M = args[2].shape[0]
    # se3 poses (C, 4, 4): 54 rows; bal_cam9 cameras (C, 19): 90
    name, width = ("bal_rows9", 90) if args[0].dim() == 2 else ("bal_rows", 54)
    assert cuda_ops.LAUNCHES[name] == (3 if M else 0)
    assert none is None and cost.shape == (M,) and rows.shape == (M, width)
    assert torch.equal(cost, again[0]) and torch.equal(rows, again[1])  # no sums across threads: the same bits
    if M == 0:
        return
    rows_scale, cost_scale = cuda_ops.bal_rows_scale(*args, loss)
    for out, r, scale in ((rows, ref[1], rows_scale), (cost[:, None], ref[0][:, None], cost_scale),
                          (only[:, None], ref[0][:, None], cost_scale)):
        assert torch.isfinite(out).all()
        err = ((out - r).double().abs() / scale.clamp(min=1e-300)).max().item()
        assert err <= tol, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("info", ["shared", "per_observation"])
@pytest.mark.parametrize("loss", sorted(ASSEMBLE_LOSSES))
def test_bal_rows_kernel_matches_plain(cuda_device, loss, info, dtype):
    """Every loss code, one sqrt_info or one an observation, at a ragged M
    (3,003: a last block of 59 observations, an odd tail of values in
    f32)."""
    args = _bal_rows_args(3003, dtype, cuda_device, info == "per_observation")
    _check_bal_rows(args, ASSEMBLE_LOSSES[loss], BAL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", [0, 1, 127, 128, 129, 200_001])
def test_bal_rows_kernel_at_every_block_edge(cuda_device, M, dtype):
    """No observation (no launch, empty outputs), one, either side of a
    block of 128 (64 in f64), and 200,001 (1,563 blocks): the kernel's
    bits repeat and match the twin."""
    args = _bal_rows_args(M, dtype, cuda_device, per_obs_info=M % 2 == 1, seed=M % 7)
    _check_bal_rows(args, CauchyLoss(2.0), BAL_TOL[dtype])


def _venice_shaped(dtype, device, loss=None):
    """A BAL problem in Venice's form at a small size: 60 cameras, 20,000
    points, 100,000 observations, fixed intrinsics, perturbed."""
    from pyslam_tpu_torch.io import bal

    data = bal.perturbed(bal.synthetic_bal(n_cams=60, n_pts=20_000, obs_per_pt=5, seed=4), seed=5)
    return build.bal_graph(data, loss=loss, dtype=dtype, device=device)


@pytest.mark.parametrize("speculative", [True, False])
def test_bal_rows_launches_once_a_linearization(cuda_device, speculative):
    """``solve_schur_large`` on a BAL graph at Venice's chunk count (128)
    launches ``bal_rows`` once a linearization and once a cost-only pass,
    and its twin never."""
    from pyslam_tpu_torch.solver import schur_large

    g = _venice_shaped(torch.float32, cuda_device)
    plan = schur_large.prepare_large_ba(g, 128)
    assert plan.bal
    calls = {"lin": 0, "cost": 0}
    linearize, cost = schur_large._linearize, schur_large._cost

    def counted(what, fn):
        def call(*a):
            calls[what] += 1
            return fn(*a)
        return call

    cuda_ops.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(schur_large, "_linearize", counted("lin", linearize))
        mp.setattr(schur_large, "_cost", counted("cost", cost))
        _, chi2, hist = schur_large.solve_schur_large(g, Options(method="lm", max_iters=5), plan=plan,
                                                      pcg_rtol=1e-4, pcg_max_iters=12, speculative=speculative)
    assert chi2 < hist[0] and calls["lin"] > 1
    assert cuda_ops.LAUNCHES["bal_rows"] == calls["lin"] + calls["cost"]
    assert cuda_ops.LAUNCHES["bal_rows_plain"] == 0


@pytest.mark.parametrize("loss", ["l2", "huber"])
def test_solve_schur_large_bal_on_the_card_matches_the_cpu_path(cuda_device, loss):
    """A BAL solve through ``bal_rows`` on the card against the CPU's (its
    twin), f64: the same accepted costs within 1e-9 and states within 1e-8;
    a second solve on the card gives the same bits."""
    from pyslam_tpu_torch.io import bal
    from pyslam_tpu_torch.solver import schur_large

    data = bal.perturbed(bal.synthetic_bal(n_cams=8, n_pts=300, seed=2), seed=3)
    opts = Options(method="lm", max_iters=10)
    kw = dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=60)
    s_c, _, h_c = schur_large.solve_schur_large(
        build.bal_graph(data, loss=ASSEMBLE_LOSSES[loss], dtype=torch.float64, device="cpu"), opts, **kw)
    g = build.bal_graph(data, loss=ASSEMBLE_LOSSES[loss], dtype=torch.float64, device=cuda_device)
    cuda_ops.reset_launches()
    s_g, _, h_g = schur_large.solve_schur_large(g, opts, **kw)
    again = schur_large.solve_schur_large(g, opts, **kw)
    assert cuda_ops.LAUNCHES["bal_rows"] > 0 and cuda_ops.LAUNCHES["bal_rows_plain"] == 0
    assert len(h_g) == len(h_c) and h_g[-1] < h_g[0]
    np.testing.assert_allclose(h_g, h_c, rtol=1e-9)
    assert again[2] == h_g and torch.equal(again[0].blocks["poses"].values, s_g.blocks["poses"].values)
    for n in s_c.blocks:
        assert (s_g.blocks[n].values.cpu() - s_c.blocks[n].values).abs().max().item() <= 1e-8


def _bal9_rows_args(M, dtype, device, per_obs_info, seed=0):
    """``bal_rows``' arguments on 9-parameter cameras: ``_bal_rows_args``'
    scene with its cameras as bal_cam9 (C, 19) = [vec(T), f, k1, k2], each
    camera's f off by up to 2% and k1, k2 off by noise, f, k1, k2 None; the
    observations 2 to 5 px from the prediction of these cameras, so that
    |r| >= 0.75 px."""
    from pyslam_tpu_torch.graph.core import FACTOR_KERNELS
    from pyslam_tpu_torch.io import bal

    poses, lms, cam, pt, _, _, _, _, info, weight = _bal_rows_args(M, torch.float64, "cpu", per_obs_info, seed)
    data = bal.synthetic_bal(n_cams=12, n_pts=max(-(-M // 4), 1), seed=seed)
    rng = np.random.default_rng(seed + 5)
    intr = np.array(data.intrinsics, dtype=np.float64)
    intr[:, 0] *= 1 + rng.uniform(-0.02, 0.02, size=len(intr))
    intr[:, 1:] += [1e-8, 1e-15] * rng.standard_normal((len(intr), 2))
    cams = torch.cat([poses.reshape(-1, 16), torch.from_numpy(intr)], -1)
    pred, _ = FACTOR_KERNELS["reprojection_bal9"](
        {"obs": torch.zeros(M, 2, dtype=torch.float64), "sqrt_info": torch.eye(2, dtype=torch.float64)}, cams[cam],
        lms[pt], compute_jacobians=False)
    off = rng.uniform(2.0, 5.0, size=(M, 2)) * rng.choice([-1.0, 1.0], size=(M, 2))
    obs = pred + torch.from_numpy(off)
    args = (cams, lms, cam, pt, obs, None, None, None, info, weight)
    return tuple(a if a is None else a.to(device, dtype).contiguous() if a.is_floating_point() else a.to(device)
                 for a in args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("info", ["shared", "per_observation"])
@pytest.mark.parametrize("loss", sorted(ASSEMBLE_LOSSES))
def test_bal_rows9_kernel_matches_plain(cuda_device, loss, info, dtype):
    """The 9-dof instantiation (90 rows, the intrinsics from the camera
    table) against its twin at every loss code, one sqrt_info or one an
    observation, M = 3,003; two launches bitwise equal."""
    args = _bal9_rows_args(3003, dtype, cuda_device, info == "per_observation")
    _check_bal_rows(args, ASSEMBLE_LOSSES[loss], BAL9_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", [0, 1, 127, 128, 129, 200_001])
def test_bal_rows9_kernel_at_every_block_edge(cuda_device, M, dtype):
    """The 9-dof blocks' edges (128 observations in f32, 64 in f64, 46,080
    bytes of staged rows either way): the bits repeat and match the twin."""
    args = _bal9_rows_args(M, dtype, cuda_device, per_obs_info=M % 2 == 1, seed=M % 7)
    _check_bal_rows(args, CauchyLoss(2.0), BAL9_TOL[dtype])


def _bal9_graph(dtype, device, n_cams=60, n_pts=20_000, seed=4):
    """A BAL problem with 9-parameter cameras, perturbed (intrinsics too),
    camera 0 frozen whole."""
    from pyslam_tpu_torch.io import bal

    data = bal.perturbed(bal.synthetic_bal(n_cams=n_cams, n_pts=n_pts, obs_per_pt=5, seed=seed), seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    intr = np.array(data.intrinsics, dtype=np.float64)
    intr[1:, 0] *= 1 + 0.01 * rng.standard_normal(n_cams - 1)
    data = bal.BALData(data.T, intr, data.pts, data.cam_idx, data.pt_idx, data.obs)
    g = build.bal_graph(data, dtype=dtype, device=device, optimize_intrinsics=True, anchor_first=False)
    pb = g.blocks["poses"]
    mask = pb.const_mask.clone()
    mask[0] = True
    return type(g)({**g.blocks, "poses": type(pb)(pb.kind, pb.values, mask)}, g.batches)


@pytest.mark.parametrize("speculative", [True, False])
def test_bal_rows9_launches_once_a_linearization(cuda_device, speculative):
    """``solve_schur_large`` on 9-parameter cameras at 128 chunks launches
    the 9-dof ``bal_rows`` once a linearization and once a cost-only pass,
    the 6-dof one and the twin never."""
    from pyslam_tpu_torch.solver import schur_large

    g = _bal9_graph(torch.float32, cuda_device)
    plan = schur_large.prepare_large_ba(g, 128)
    assert plan.bal and plan.dp == 9
    calls = {"lin": 0, "cost": 0}
    linearize, cost = schur_large._linearize, schur_large._cost

    def counted(what, fn):
        def call(*a):
            calls[what] += 1
            return fn(*a)
        return call

    cuda_ops.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(schur_large, "_linearize", counted("lin", linearize))
        mp.setattr(schur_large, "_cost", counted("cost", cost))
        _, chi2, hist = schur_large.solve_schur_large(g, Options(method="lm", max_iters=5), plan=plan,
                                                      pcg_rtol=1e-4, pcg_max_iters=12, speculative=speculative)
    assert chi2 < hist[0] and calls["lin"] > 1
    assert cuda_ops.LAUNCHES["bal_rows9"] == calls["lin"] + calls["cost"]
    assert cuda_ops.LAUNCHES["bal_rows"] == cuda_ops.LAUNCHES["bal_rows_plain"] == 0


def test_solve_schur_large_bal9_on_the_card_matches_the_cpu_path(cuda_device):
    """A 9-dof solve through ``bal_rows`` on the card against the CPU's (its
    twin), f64: the same accepted costs within 1e-9 and states within 1e-8
    relative; a second solve on the card gives the same bits."""
    from pyslam_tpu_torch.solver import schur_large

    opts = Options(method="lm", max_iters=10)
    kw = dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=60)
    s_c, _, h_c = schur_large.solve_schur_large(_bal9_graph(torch.float64, "cpu", 8, 300, 2), opts, **kw)
    g = _bal9_graph(torch.float64, cuda_device, 8, 300, 2)
    cuda_ops.reset_launches()
    s_g, _, h_g = schur_large.solve_schur_large(g, opts, **kw)
    again = schur_large.solve_schur_large(g, opts, **kw)
    assert cuda_ops.LAUNCHES["bal_rows9"] > 0 and cuda_ops.LAUNCHES["bal_rows_plain"] == 0
    assert len(h_g) == len(h_c) and h_g[-1] < h_g[0]
    np.testing.assert_allclose(h_g, h_c, rtol=1e-9)
    assert again[2] == h_g and torch.equal(again[0].blocks["poses"].values, s_g.blocks["poses"].values)
    for n in s_c.blocks:
        np.testing.assert_allclose(s_g.blocks[n].values.cpu().numpy(), s_c.blocks[n].values.numpy(), rtol=1e-8,
                                   atol=1e-8)


# --------------------------------------------------------------------------
# The sparse direct paths: sparse_chol, schur_sparse, and the batched fleet
# --------------------------------------------------------------------------


def _manhattan(n_poses, dtype, device):
    return build.pose_graph(synth.se2_manhattan(n_poses=n_poses, seed=4), dtype=dtype, device=device)


def _check_slot_plan(device, perm, offsets, n_slots, C, dtype, seed):
    """``slot_reduce`` against its plain version on random rows at one
    plan, two runs bitwise equal."""
    E = perm.shape[0]
    contrib = torch.from_numpy(np.random.default_rng(seed).normal(size=(E, C))).to(device, dtype)
    cuda_ops.reset_launches()
    out = slot_reduce(contrib, perm, offsets, n_slots)
    again = slot_reduce(contrib, perm, offsets, n_slots)
    ref = slot_reduce_plain(contrib, perm, offsets, n_slots)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["slot_reduce"] == 2
    assert torch.equal(out, again)
    _assert_close(out, ref, KERNEL_TOL[dtype])
    _check_tiled(out, contrib, perm, offsets, n_slots)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slot_reduce_at_the_forward_solve_plans_of_sparse_chol(cuda_device, dtype):
    """Every wave's sum of the multifrontal forward solve (boundary rows by
    variable, the pad row as the last destination)."""
    plan = sparse_chol.build_chol_plan(_manhattan(600, dtype, cuda_device))
    waves = [w for w in sparse_chol._device_waves(plan, cuda_device) if w.fwd_dest.numel()]
    assert len(waves) > 5
    for i, w in enumerate(waves):
        _check_slot_plan(cuda_device, w.fwd_perm, w.fwd_offsets, w.fwd_slots, plan.d, dtype, i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slot_reduce_at_the_S_plan_of_schur_sparse(cuda_device, dtype):
    """The assembly of S: [Hpp, PP, PP^T, -pair blocks] into the ELL slots."""
    g = build.landmark_slam_2d(synth.landmark_slam_2d(n_poses=300, n_landmarks=60, max_range=6.0, seed=0),
                               dtype=dtype, device=cuda_device)
    plan = schur_sparse.build_schur_sparse_plan(g)
    t = schur_sparse.plan_tables(plan, cuda_device)
    assert plan.n_pairs > 1000
    _check_slot_plan(cuda_device, t.perm, t.offsets, t.n_slots, plan.dp * plan.dp, dtype, 7)


def _repeats_and_matches_cpu(run, make):
    """Two runs on the card give the same bits, through slot_reduce and no
    plain version, with one host read an LM iteration; in f64 the CPU path's
    iterations, accept sequence and chi2 (1e-9 relative)."""
    cuda_ops.reset_launches()
    linear.reset_host_reads()
    s1, i1 = run(make("cuda"))
    assert linear.HOST_READS == {"pcg": 0, "lm": i1.iterations}
    assert cuda_ops.LAUNCHES["slot_reduce"] > 0 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    s2, i2 = run(make("cuda"))
    assert torch.equal(i1.chi2, i2.chi2)
    for n in s1.blocks:
        assert torch.equal(s1.blocks[n].values, s2.blocks[n].values)
    s_c, i_c = run(make("cpu"))
    assert (i1.iterations, i1.status) == (i_c.iterations, i_c.status)
    assert i1.accepted.cpu().tolist() == i_c.accepted.tolist()
    assert abs(i1.chi2.item() - i_c.chi2.item()) <= 1e-9 * i_c.chi2.item()


def test_solve_sparse_chol_on_the_card_repeats_bit_for_bit(cuda_device):
    _repeats_and_matches_cpu(lambda g: sparse_chol.solve_sparse_chol(g, Options(method="lm", max_iters=20)),
                             lambda device: _manhattan(600, torch.float64, device))


def test_solve_schur_sparse_on_the_card_repeats_bit_for_bit(cuda_device):
    data = synth.landmark_slam_2d(n_poses=300, n_landmarks=60, max_range=6.0, seed=0)
    _repeats_and_matches_cpu(lambda g: schur_sparse.solve_schur_sparse(g, Options(method="lm", max_iters=20)),
                             lambda device: build.landmark_slam_2d(data, dtype=torch.float64, device=device))


def test_solve_batched_on_the_card_matches_the_cpu_path(cuda_device):
    datas = [synth.se2_loop(n_poses=40, n_loops=5, seed=s) for s in range(6)]
    opts = Options(method="lm", max_iters=30)
    res = {}
    for device in ("cpu", cuda_device):
        linear.reset_host_reads()
        cuda_ops.reset_launches()
        res[str(device)] = solver.solve_batched(
            [build.pose_graph(d, dtype=torch.float64, device=device) for d in datas], opts, return_info=True)
        assert linear.HOST_READS["lm"] == max(res[str(device)][2].iterations)
    (v_c, c_c, i_c), (v_g, c_g, i_g) = res["cpu"], res[str(cuda_device)]
    assert cuda_ops.LAUNCHES["slot_reduce"] > 0 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    assert i_g.iterations == i_c.iterations and i_g.status == i_c.status
    assert torch.equal(i_g.accepted.cpu(), i_c.accepted)
    _assert_close(c_g.cpu(), c_c, 1e-9)
    _assert_close(v_g["poses"].cpu(), v_c["poses"], 1e-9)


# --------------------------------------------------------------------------
# Initialization, switchable loop closures, GNC and VIO: the card's path
# against the CPU path in f64
# --------------------------------------------------------------------------


def _same_solve(res, rel=1e-8, block="poses"):
    (s_c, i_c), (s_g, i_g) = res["cpu"], res["cuda"]
    assert (i_g.iterations, i_g.status) == (i_c.iterations, i_c.status)
    assert torch.equal(i_g.accepted.cpu(), i_c.accepted)
    assert abs(i_g.chi2.item() - i_c.chi2.item()) <= rel * i_c.chi2.item()
    _assert_close(s_g.blocks[block].values.cpu(), s_c.blocks[block].values, 1e-9)


def test_chordal_init_on_the_card_matches_the_cpu_path(cuda_device):
    from pyslam_tpu_torch.graph import initialize

    for data in (synth.se2_loop(n_poses=80, seed=5), synth.se3_sphere(n_poses=120, seed=2)):
        n = data.T_gt.shape[0]
        T = {str(dev): initialize.chordal_init(data.edges_i, data.edges_j, data.T_meas, n, device=dev)
             for dev in ("cpu", cuda_device)}
        np.testing.assert_allclose(T[str(cuda_device)], T["cpu"], rtol=0, atol=1e-8)


def test_switchable_solve_on_the_card_matches_the_cpu_path(cuda_device):
    data, _ = synth.with_outliers(synth.se2_loop(n_poses=60, n_loops=8, seed=0), 3, seed=1)
    opts = Options(method="lm", max_iters=60)
    res = {("cpu" if dev == "cpu" else "cuda"): lm.solve(
        build.switchable_pose_graph(data, xi=5.0, dtype=torch.float64, device=dev), opts) for dev in ("cpu", cuda_device)}
    _same_solve(res)
    _same_solve(res, block="switches")


def test_solve_gnc_on_the_card_matches_the_cpu_path(cuda_device):
    data, _ = synth.with_outliers(synth.se3_sphere(n_poses=60, n_loops=8, seed=6), 4, seed=1)
    opts = Options(method="lm", max_iters=30, min_cost_decrease=0.999)
    out = {}
    for dev in ("cpu", cuda_device):
        cuda_ops.reset_launches()
        out[str(dev)] = solver.solve_gnc(build.pose_graph(data, dtype=torch.float64, device=dev), opts,
                                         solve_fn=bcsr.solve_ell)
    assert cuda_ops.LAUNCHES["ell_assemble"] > 0 and cuda_ops.LAUNCHES["ell_pcg"] > 0
    (s_c, i_c), (s_g, i_g) = out["cpu"], out[str(cuda_device)]
    assert i_g.outer_iters == i_c.outer_iters
    np.testing.assert_array_equal(i_g.inlier_masks[0], i_c.inlier_masks[0])
    assert abs(i_g.chi2 - i_c.chi2) <= 1e-8 * i_c.chi2
    _assert_close(s_g.blocks["poses"].values.cpu(), s_c.blocks["poses"].values, 1e-9)


def test_vio_on_the_card_matches_the_cpu_path(cuda_device):
    from pyslam_tpu_torch import imu
    from pyslam_tpu_torch.lie import se3

    d = synth.imu_circle(n_keyframes=12, kf_dt=0.5, imu_rate=200, gyro_noise=1.7e-4 * np.sqrt(200),
                         accel_noise=2e-3 * np.sqrt(200), b_gyro=[0.002, -0.001, 0.003], b_accel=[0.05, -0.03, 0.02])
    rng = np.random.default_rng(1)
    T_prior = np.stack([se3.exp(torch.from_numpy(rng.normal(size=6) * 2e-3)).numpy() @ d.T_gt[i] for i in range(12)])
    res = {}
    for dev in ("cpu", cuda_device):
        g = imu.vio_graph(d, T_prior, np.diag([1 / 2e-3] * 6), T_init=T_prior, v_init=np.zeros((12, 3)),
                          b_init=np.zeros((12, 6)), device=dev)
        res["cpu" if dev == "cpu" else "cuda"] = lm.solve(g, Options(method="lm", max_iters=60))
    _same_solve(res)
    _same_solve(res, block="vels")
    # the batched recursion on the card against the per-interval one
    batched = imu._preintegrate_batched(*(torch.from_numpy(np.asarray(x)).to(cuda_device) for x in
                                          (d.omega, d.accel, d.dts)),
                                        *(torch.zeros((11, 3), dtype=torch.float64, device=cuda_device),) * 2,
                                        1.7e-4, 2e-3)
    for i in (0, 5, 10):
        one = imu.preintegrate(d.omega[i], d.accel[i], d.dts[i], np.zeros(3), np.zeros(3), device=cuda_device)
        for name in one._fields:
            _assert_close(getattr(batched, name)[i], getattr(one, name), 1e-12)


# --------------------------------------------------------------------------
# Online and marginalized estimation (slot_reduce at their shapes, the
# smoothers, marginalize and schur_sqrt against the CPU path in f64)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slot_reduce_at_the_schur_sqrt_shape(cuda_device, dtype):
    """The reduced camera system of the square-root path at Ladybug-49's
    size: 112,000 camera-pair contributions of width 36 into the 128
    co-observing pairs of its 2,401 blocks (clustered cameras: up to 6,758
    rows a pair), and the gradient rows (width 6 into 49), against the plain
    version, a second run and the host model of the kernel's order."""
    from pyslam_tpu_torch.io import bal
    from pyslam_tpu_torch.solver import schur_sqrt

    g = build.bal_graph(bal.perturbed(bal.synthetic_bal(49, 7000, seed=0, cam_cluster=0.05)), device=cuda_device)
    plan = schur_sqrt.build_sqrt_plan(g)
    assert len(plan.pair_plan[0]) == 112_000 and plan.C == 49
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for (perm, offsets), width, n_slots in ((plan.pair_plan, 36, len(plan.pair_blocks)), (plan.grad_plan, 6, 49)):
        perm, offsets = (torch.from_numpy(a).to(cuda_device) for a in (perm, offsets))
        contrib = torch.randn((len(perm), width), generator=gen, device=cuda_device, dtype=dtype)
        out = slot_reduce(contrib, perm, offsets, n_slots)
        ref = slot_reduce_plain(contrib, perm, offsets, n_slots)
        _assert_close(out, ref, KERNEL_TOL[dtype])
        assert torch.equal(out, slot_reduce(contrib, perm, offsets, n_slots))
        _check_tiled(out, contrib, perm, offsets, n_slots)


def _gn_makes_no_sync(sm, state):
    torch.cuda.set_sync_debug_mode("error")
    try:
        sm._gn_steps(*state)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_fixed_lag_on_the_card_matches_the_cpu_path(cuda_device):
    """Phase 33 of the smoke at a small size: the SE(3) window on the card
    and on the CPU, f64, every pose within 1e-9; a GN step on the card makes
    no synchronizing call."""
    from pyslam_tpu_torch.solver import FixedLagSmoother
    from pyslam_tpu_torch.testing import drive_fixed_lag, window_trajectory

    data = synth.se3_sphere(n_poses=60, n_loops=10, seed=3)
    out = {}
    for dev in ("cpu", cuda_device):
        sm = FixedLagSmoother(window=12, kind="se3", gn_iters=3, anchor_sqrt_info=1e4, dtype=torch.float64, device=dev)
        cuda_ops.reset_launches()
        out[str(dev)] = window_trajectory(*drive_fixed_lag(sm, data, 60), 60)
    assert cuda_ops.LAUNCHES["slot_reduce"] > 0 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    np.testing.assert_allclose(out[str(cuda_device)], out["cpu"], rtol=0, atol=1e-9)
    _gn_makes_no_sync(sm, sm._device_plan())


def test_fixed_lag_landmarks_on_the_card_matches_the_cpu_path(cuda_device):
    """Phase 34 of the smoke at a small size: bearing-range landmarks with
    eviction, f64, poses and retired landmarks within 1e-9, the same
    retirements; a GN step makes no synchronizing call."""
    from pyslam_tpu_torch.solver import FixedLagLandmarkSmoother
    from pyslam_tpu_torch.testing import drive_fixed_lag_landmarks, window_trajectory

    data = synth.landmark_slam_2d(n_poses=60, n_landmarks=30, max_range=10.0, obs_type="bearing_range",
                                  odo_rot_std=0.005, seed=0)
    out = {}
    for dev in ("cpu", cuda_device):
        sm = FixedLagLandmarkSmoother(window=10, lm_slots=12, obs_kind="bearing_range_se2", kind="se2", gn_iters=3,
                                      dtype=torch.float64, device=dev)
        left, last, ret = drive_fixed_lag_landmarks(sm, data, 60)
        out[str(dev)] = (window_trajectory(left, last, 60), ret)
    (p_c, r_c), (p_g, r_g) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(p_g, p_c, rtol=0, atol=1e-9)
    assert [i for i, _ in r_g] == [i for i, _ in r_c] and len(r_c) > 0
    np.testing.assert_allclose(np.stack([v for _, v in r_g]), np.stack([v for _, v in r_c]), rtol=0, atol=1e-9)
    _gn_makes_no_sync(sm, sm._device_state())


def test_incremental_and_marginalize_on_the_card_match_the_cpu_path(cuda_device):
    from pyslam_tpu_torch.graph import marginalize
    from pyslam_tpu_torch.solver import IncrementalSmoother
    from pyslam_tpu_torch.testing import drive_incremental

    data = synth.se2_loop(n_poses=60, n_loops=8, seed=2)
    ups, poses = {}, {}
    for dev in ("cpu", cuda_device):
        sm = IncrementalSmoother(kind="se2", device=dev)
        ups[str(dev)] = drive_incremental(sm, data, every=10)
        sm.marginalize_oldest(keep_last=20)
        _, info = sm.update()
        ups[str(dev)].append((info.chi2.item(), info.iterations))
        poses[str(dev)] = sm.poses()
    assert [i for _, i in ups["cpu"]] == [i for _, i in ups[str(cuda_device)]]
    np.testing.assert_allclose([c for c, _ in ups[str(cuda_device)]], [c for c, _ in ups["cpu"]], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(poses[str(cuda_device)], poses["cpu"], rtol=0, atol=1e-9)
    g = {str(dev): marginalize(build.pose_graph(data, dtype=torch.float64, device=dev), {"poses": [5, 6, 30]})
         for dev in ("cpu", cuda_device)}
    (prior_c,), (prior_g,) = ([fb for fb in g[k].batches if fb.kind.startswith("dense_prior")] for k in g)
    A_c, A_g = prior_c.data["A"][0], prior_g.data["A"][0].cpu()
    _assert_close(A_g.T @ A_g, A_c.T @ A_c, 1e-9)
    assert prior_g.data["A"].device.type == "cuda"


def test_solve_schur_sqrt_on_the_card_matches_the_cpu_path(cuda_device):
    from pyslam_tpu_torch.io import bal
    from pyslam_tpu_torch.solver import schur_sqrt

    data = bal.perturbed(bal.synthetic_bal(n_cams=6, n_pts=50, seed=0, cam_cluster=0.05))
    res = {}
    for dev in ("cpu", cuda_device):
        cuda_ops.reset_launches()
        res["cpu" if dev == "cpu" else "cuda"] = schur_sqrt.solve_schur_sqrt(
            build.bal_graph(data, dtype=torch.float64, device=dev), Options(method="lm", max_iters=25))
    assert cuda_ops.LAUNCHES["slot_reduce"] > 0 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    _same_solve(res)
    _same_solve(res, block="landmarks")


# --------------------------------------------------------------------------
# Differentiable slot_reduce, solve_implicit and the object API on the card
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_slots,E,C", [(2500, 9896, 6), (3500, 7814, 9), (49, 25769, 36), (300, 1000, 5),
                                         (10, 0, 36)])
def test_slot_reduce_backward_matches_plain_autograd(cuda_device, n_slots, E, C, dtype):
    """The kernel's autograd Function against autograd through the plain
    version: its backward is the gather of ``slot_reduce_backward``, the
    same bits twice; the forward launches the kernel, never the plain one."""
    rng = np.random.default_rng(E + C)
    sp = cuda_ops.slot_plan(rng.integers(0, n_slots, E), n_slots)
    perm, offsets = (torch.from_numpy(a).to(cuda_device) for a in (sp.perm, sp.offsets))
    contrib = torch.from_numpy(rng.normal(size=(E, C))).to(cuda_device, dtype)
    weights = torch.from_numpy(rng.normal(size=(n_slots, C))).to(cuda_device, dtype)
    grads = []
    for _ in range(2):
        x = contrib.clone().requires_grad_()
        cuda_ops.reset_launches()
        out = slot_reduce(x, perm, offsets, n_slots)
        (g,) = torch.autograd.grad((out * weights).sum(), x)
        torch.cuda.synchronize()
        assert cuda_ops.LAUNCHES["slot_reduce"] == 1 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
        grads.append(g)
    assert torch.equal(grads[0], grads[1])
    x = contrib.clone().requires_grad_()
    (ref,) = torch.autograd.grad((slot_reduce_plain(x, perm, offsets, n_slots) * weights).sum(), x)
    if E:
        _assert_close(grads[0], ref, KERNEL_TOL[dtype])
        _assert_close(out.detach(), slot_reduce_plain(contrib, perm, offsets, n_slots), KERNEL_TOL[dtype])


def test_slot_reduce_gradcheck_on_the_card(cuda_device):
    rng = np.random.default_rng(0)
    sp = cuda_ops.slot_plan(rng.integers(0, 7, 40), 7)
    perm, offsets = (torch.from_numpy(a).to(cuda_device) for a in (sp.perm, sp.offsets))
    x = torch.from_numpy(rng.normal(size=(40, 6))).to(cuda_device).requires_grad_()
    assert torch.autograd.gradcheck(lambda c: slot_reduce(c, perm, offsets, 7), (x,))


def _implicit_gradient(device):
    from pyslam_tpu_torch.graph.core import FactorBatch, FactorGraph
    from pyslam_tpu_torch.solver import solve_implicit

    g = build.pose_graph(synth.se2_loop(n_poses=10, n_loops=2, seed=0), dtype=torch.float64, device=device)
    fb = g.batches[0]
    T = fb.data["T_obs"].clone().requires_grad_()
    fb2 = FactorBatch(fb.kind, fb.slots, fb.indices, {**fb.data, "T_obs": T}, fb.loss, fb.weight)
    opts = Options(method="lm", max_iters=60, min_cost_decrease=1 - 1e-13, min_update_norm=1e-14)
    values, chi2 = solve_implicit(FactorGraph(g.blocks, [fb2]), opts)
    cuda_ops.reset_launches()
    (grad,) = torch.autograd.grad(values["poses"][-1, :2, 2].sum() + 0.1 * chi2, T)
    return grad, dict(cuda_ops.LAUNCHES)


def test_solve_implicit_on_the_card_matches_the_cpu_path(cuda_device):
    """The backward through the kernel (never the plain assembly) against
    the CPU path's gradient."""
    ref, _ = _implicit_gradient("cpu")
    grad, launches = _implicit_gradient(cuda_device)
    assert launches["slot_reduce"] == 3 and launches["slot_reduce_plain"] == 0
    _assert_close(grad.cpu(), ref, 1e-8)


def test_problem_on_the_card_matches_the_cpu_path(cuda_device):
    import pyslam_tpu_torch as T

    data = synth.se2_loop(n_poses=12, n_loops=3, seed=4)
    out = {}
    for dev in ("cpu", cuda_device):
        problem = T.Problem(T.Options(max_iters=30), dtype=torch.float64, device=dev)
        names = [f"T_{i}" for i in range(12)]
        for i, j, Tm, S in zip(data.edges_i, data.edges_j, data.T_meas, data.sqrt_info):
            problem.add_residual_block(T.PoseToPoseResidual(T.SE2(Tm), S), [names[i], names[j]])
        problem.initialize_params({n: T.SE2(Tk) for n, Tk in zip(names, data.T_init)})
        problem.set_parameters_constant(names[0])
        problem.solve()
        problem.compute_covariance(dense_dof_limit=4)
        out[str(dev)] = (problem.param_dict["T_7"].mat.cpu(), problem.get_covariance_block("T_3", "T_7").cpu(),
                         problem.eval_cost())
    (p_c, c_c, e_c), (p_g, c_g, e_g) = out["cpu"], out[str(cuda_device)]
    _assert_close(p_g, p_c, 1e-9)
    _assert_close(c_g, c_c, 1e-8)
    np.testing.assert_allclose(e_g, e_c, rtol=1e-8)


def test_assemble_dense_is_differentiable_on_the_card(cuda_device):
    """H, g and chi2 of the dense assembly, with its in-place masking, by
    the kernel's autograd Function, against finite differences."""
    from pyslam_tpu_torch.graph.core import FactorBatch, FactorGraph

    g = build.pose_graph(synth.se2_loop(n_poses=6, n_loops=1, seed=0), dtype=torch.float64, device=cuda_device)
    fb = g.batches[0]
    rng = np.random.default_rng(2)
    R = torch.from_numpy(rng.normal(size=(g.total_dof,) * 2)).to(cuda_device)
    v = torch.from_numpy(rng.normal(size=g.total_dof)).to(cuda_device)

    def f(T_obs):
        fb2 = FactorBatch(fb.kind, fb.slots, fb.indices, {**fb.data, "T_obs": T_obs}, fb.loss, fb.weight)
        H, gvec, chi2 = assemble.assemble_dense(FactorGraph(g.blocks, [fb2]))
        return (H * R).sum() + (gvec * v).sum() + chi2

    cuda_ops.reset_launches()
    assert torch.autograd.gradcheck(f, (fb.data["T_obs"].clone().requires_grad_(),))
    assert cuda_ops.LAUNCHES["slot_reduce"] > 0 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0


# ---- the VO frontend (pipelines/): the card against the CPU in float64 ----


@pytest.mark.parametrize("kind", ["photometric_se3", "photometric_affine_se3"])
def test_photometric_kernel_on_the_card_matches_cpu(cuda_device, kind):
    """r and J of three factors (the corner-packed sampling, one frame a
    factor, one pose taking half the plane out of view), 1e-12."""
    from pyslam_tpu_torch.graph.core import FACTOR_KERNELS
    from pyslam_tpu_torch.lie import se3
    from pyslam_tpu_torch.pipelines import PhotometricResidualSE3
    from pyslam_tpu_torch.sensors import RGBDCamera
    from pyslam_tpu_torch.testing import PLANE_CAM, render_rgbd
    from pyslam_tpu_torch.utils import pack_corners

    rng = np.random.default_rng(0)
    im, depth = render_rgbd(np.zeros(3))
    depth[:5] = np.nan
    res = PhotometricResidualSE3(RGBDCamera(**PLANE_CAM), im, depth, im, stiffness=1.0)
    tracks = np.stack([render_rgbd(rng.normal(0, 0.03, 3))[0] for _ in range(3)])
    xi = rng.normal(0, 0.01, (3, 6))
    xi[-1, 0] = 1.5
    out = {}
    for dev in ("cpu", cuda_device):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        data = dict(camera=res.camera, pt_ref=t(np.repeat(res.pt_ref[None], 3, 0)),
                    I_ref=t(np.repeat(res.I_ref[None], 3, 0)), mask=t(np.repeat(res.mask[None], 3, 0).astype(float)),
                    im_track=t(tracks), stiffness=t(np.full(3, 2.0)))
        data["im_track4"] = torch.func.vmap(pack_corners)(data["im_track"])
        r, (J,) = FACTOR_KERNELS[kind](data, se3.exp(t(xi)))
        out[str(dev)] = (r.cpu(), J.cpu())
    (r_c, J_c), (r_g, J_g) = out["cpu"], out[str(cuda_device)]
    _assert_close(r_g, r_c, 1e-12)
    _assert_close(J_g, J_c, 1e-12)


def test_block_match_on_the_card_matches_cpu(cuda_device):
    """The same NaN mask and disparities, in float32 (the reference's type)
    and float64."""
    from pyslam_tpu_torch.pipelines.stereo_match import block_match

    rng = np.random.default_rng(3)
    H, W, pad, d_true = 96, 192, 64, 17
    tex = rng.uniform(0, 1, (H, W + 2 * pad))
    tex = np.apply_along_axis(lambda r: np.convolve(r, np.ones(3) / 3, mode="same"), 1, tex)
    left = tex[:, pad: pad + W]
    right = tex[:, pad + d_true: pad + d_true + W] + 0.01 * rng.standard_normal((H, W))
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        d_c = block_match(left, right, num_disparities=48, dtype=dtype, device="cpu").numpy()
        d_g = block_match(left, right, num_disparities=48, dtype=dtype, device=cuda_device).cpu().numpy()
        m = np.isfinite(d_c)
        np.testing.assert_array_equal(np.isfinite(d_g), m)
        assert m.mean() > 0.3
        np.testing.assert_allclose(d_g[m], d_c[m], rtol=0, atol=tol)


def test_three_frame_track_on_the_card_matches_cpu(cuda_device):
    """A float64 RGB-D pipeline, three frames (the keyframe and two
    tracked, the second prefetched) and a ``track_batch`` of two: the card's
    poses within 1e-8 of the CPU's, and its LM launching ``slot_reduce``."""
    from pyslam_tpu_torch.pipelines import DenseRGBDPipeline
    from pyslam_tpu_torch.sensors import RGBDCamera
    from pyslam_tpu_torch.testing import PLANE_CAM, render_rgbd

    frames = [render_rgbd(np.array([0.02 * k, 0.01 * k, 0.005 * k])) for k in range(5)]
    out = {}
    for dev in ("cpu", cuda_device):
        pipe = DenseRGBDPipeline(RGBDCamera(**PLANE_CAM), pyrlevels=3, keyframe_trans_thresh=10.0,
                                 dtype=torch.float64, device=dev)
        cuda_ops.reset_launches()
        pipe.track(*frames[0])
        pipe.track(*frames[1])
        pipe.track(pipe.prefetch(frames[2][0]), frames[2][1])
        pipe.track_batch([f[0] for f in frames[3:]])
        out[str(dev)] = np.stack(pipe.T_c_w)
        if str(dev) != "cpu":
            assert cuda_ops.LAUNCHES["slot_reduce"] > 0 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    np.testing.assert_allclose(out[str(cuda_device)], out["cpu"], rtol=0, atol=1e-8)


# --------------------------------------------------------------------------
# The last modules: solve_schur_cm, the cluster and stale preconditioners,
# two-level PCG and the BCSR family
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_matvec_at_the_ell_pattern_shape(cuda_device, dtype):
    """``bcsr.ell_matvec`` over ``ell_blocks`` of a damped BCSR store, whose
    padding slots name column 0 with zero blocks (the kernel assumes
    nothing of slot 0), against its plain version and the upper store's
    ``bcsr_matvec``."""
    g = build.pose_graph(synth.se3_sphere(n_poses=300, seed=0), dtype=dtype, device=cuda_device)
    pattern = bcsr.build_pattern(g)
    H = bcsr.damp_blocks(bcsr.assemble_bcsr(g, pattern)[0], pattern, 1e-3)
    ell = bcsr.build_ell(pattern)
    He = bcsr.ell_blocks(H, ell)
    cols = bcsr._ell_tables(ell, cuda_device).cols
    x = torch.from_numpy(np.random.default_rng(3).normal(size=ell.nb * ell.d)).to(cuda_device, dtype)
    cuda_ops.reset_launches()
    out = bcsr.ell_matvec(He, ell, x)
    again = bcsr.ell_matvec(He, ell, x)
    ref = ell_matvec_plain(He, cols, x)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["ell_matvec"] == 2 and torch.equal(out, again)
    assert (ell.valid == 0).any() and not ell.cols[ell.valid == 0].any()
    _assert_close(out, ref, KERNEL_TOL[dtype])
    _assert_close(out, bcsr.bcsr_matvec(H, pattern, x), KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slot_reduce_at_the_bcsr_and_coarse_plans(cuda_device, dtype):
    g = build.pose_graph(synth.se3_sphere(n_poses=300, seed=0), dtype=dtype, device=cuda_device)
    pattern = bcsr.build_pattern(g)
    dp = bcsr.bcsr_device_plan(pattern, cuda_device)
    coarse = bcsr._coarse_plan(g, bcsr.build_ell_direct(g), 32, cuda_device)
    for k, (seg, C) in enumerate(((dp.to_slot, 36), (dp.to_pose, 6), (dp.by_row, 6), (dp.by_col, 6),
                                  (coarse.to_coarse, 36), (coarse.by_group, 6))):
        _check_slot_plan(cuda_device, seg.perm, seg.offsets, seg.n_slots, C, dtype, k)


@pytest.mark.parametrize("precond", ["cluster", "stale"])
def test_slot_reduce_at_the_pair_plans_of_the_preconditioners(cuda_device, precond):
    from pyslam_tpu_torch.solver import schur_large

    plan = schur_large.prepare_large_ba(build.ba_graph(synth.ba_synthetic(n_cams=30, n_pts=600, seed=1),
                                                       dtype=torch.float64, device=cuda_device), 4)
    pairs = (schur_large.build_cluster_pairs(plan, 8, 2) if precond == "cluster"
             else schur_large.build_dense_pairs(plan, 2))
    for dtype in (torch.float32, torch.float64):
        _check_slot_plan(cuda_device, pairs.by_block.perm, pairs.by_block.offsets, pairs.by_block.n_slots, 36, dtype, 7)


@pytest.mark.parametrize("kw", [dict(precond="cluster", cluster_size=3), dict(precond="stale", stale_refresh=2)])
def test_schur_large_preconditioners_on_the_card_match_the_cpu_path(cuda_device, kw):
    from pyslam_tpu_torch.solver import schur_large

    data = synth.ba_synthetic(n_cams=8, n_pts=64, seed=3)
    opts = Options(method="lm", max_iters=12)
    common = dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=50, **kw)
    _, c_c, h_c = schur_large.solve_schur_large(build.ba_graph(data, dtype=torch.float64, device="cpu"), opts,
                                                **common)
    cuda_ops.reset_launches()
    linear.reset_host_reads()
    _, c_g, h_g = schur_large.solve_schur_large(build.ba_graph(data, dtype=torch.float64, device=cuda_device), opts,
                                                **common)
    assert cuda_ops.LAUNCHES["slot_reduce"] > 0 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    assert linear.HOST_READS["pcg"] == 0
    assert len(h_g) == len(h_c)
    np.testing.assert_allclose(h_g, h_c, rtol=1e-9)


@pytest.mark.parametrize("case", ["two_level", "bcsr_ell", "bcsr_bcsr", "bcsr_ell_g8"])
def test_two_level_and_bcsr_on_the_card_match_the_cpu_path(cuda_device, case):
    """f64 solves on the card against the CPU path, no host read in a
    linear solve, the products ``ell_matvec`` launches (the ELL cases)."""
    data = synth.se3_sphere(n_poses=60, seed=11)
    opts = Options(method="lm", max_iters=15)

    def run(g):
        if case == "two_level":
            return bcsr.solve_ell(g, opts, pcg_rtol=1e-8, pcg_max_iters=600, precond="two_level", coarse_size=16)
        spmv, group = {"bcsr_ell": ("ell", 1), "bcsr_bcsr": ("bcsr", 1), "bcsr_ell_g8": ("ell", 8)}[case]
        return bcsr.solve_bcsr(g, opts, spmv=spmv, precond_group=group)

    s_c, i_c = run(build.pose_graph(data, dtype=torch.float64, device="cpu"))
    cuda_ops.reset_launches()
    linear.reset_host_reads()
    s_g, i_g = run(build.pose_graph(data, dtype=torch.float64, device=cuda_device))
    assert linear.HOST_READS["pcg"] == 0 and cuda_ops.LAUNCHES["ell_pcg"] == 0
    assert cuda_ops.LAUNCHES["slot_reduce_plain"] == cuda_ops.LAUNCHES["ell_matvec_plain"] == 0
    assert cuda_ops.LAUNCHES["ell_matvec"] > 0 or case == "bcsr_bcsr"
    assert i_g.iterations == i_c.iterations
    np.testing.assert_allclose(i_g.chi2.item(), i_c.chi2.item(), rtol=1e-9)
    assert (s_g.blocks["poses"].values.cpu() - s_c.blocks["poses"].values).abs().max().item() <= 1e-8


def test_schur_cm_on_the_card_matches_the_cpu_path(cuda_device, tmp_path):
    """``solve_schur_cm`` on a one-rank world over gloo with the rank on the
    card, against the CPU path in f64."""
    from pyslam_tpu_torch import dist

    data = synth.ba_synthetic(n_cams=8, n_pts=64, seed=3)
    opts = Options(method="lm", max_iters=12)
    dist.init_distributed(f"file://{tmp_path / 'world'}", 1, 0, backend="gloo", device="cpu")
    try:
        out = {}
        for dev in ("cpu", cuda_device):
            mesh = dist.make_mesh(axis_name="l", device=dev)
            cuda_ops.reset_launches()
            solved, chi2, hist = dist.solve_schur_cm(build.ba_graph(data, dtype=torch.float64, device=dev), mesh, opts,
                                                     n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=60)
            out[str(dev)] = (hist, solved.blocks["poses"].values.cpu())
            if dev != "cpu":
                assert cuda_ops.LAUNCHES["slot_reduce"] > 0 and cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    finally:
        torch.distributed.destroy_process_group()
    (h_c, p_c), (h_g, p_g) = out["cpu"], out[str(cuda_device)]
    assert len(h_g) == len(h_c)
    np.testing.assert_allclose(h_g, h_c, rtol=1e-9)
    assert (p_g - p_c).abs().max().item() <= 1e-8
