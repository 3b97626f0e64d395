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
from pyslam_tpu_torch.losses import L2Loss
from pyslam_tpu_torch.solver import cuda_ops
from pyslam_tpu_torch.solver.bcsr import slot_plan
from pyslam_tpu_torch.solver.cuda_ops import ell_matvec, slot_reduce, slot_reduce_plain
from torch_support import (  # noqa: F401
    CHUNK_STRIDE, block_slot_sum, one_torch_thread, sequential_slot_sum, slot_reduce_model, tiled_slot_sum)


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


@pytest.mark.parametrize("n_slots", [1, 49, 1 << 16, (1 << 16) + 1, 343_000, 5_000_000])
@pytest.mark.parametrize("E", [0, 1, 1000, 30_000])
def test_slot_plan_sorts_as_numpy_stable_argsort(n_slots, E):
    """The plan sorts 16 bits of the destination at a time (numpy's radix
    sort); the order is that of one stable sort of the whole key, and the
    ELL slot plans of the reference are built on that order."""
    dest = np.random.default_rng(n_slots % 97 + E).integers(0, n_slots, E)
    plan = slot_plan(dest, n_slots)
    np.testing.assert_array_equal(plan.perm, np.argsort(dest, kind="stable"))
    assert plan.perm.dtype == np.int32 and plan.offsets.dtype == np.int32 and plan.offsets.shape == (n_slots + 1,)
    np.testing.assert_array_equal(np.diff(plan.offsets), np.bincount(dest, minlength=n_slots))


def test_slot_reduce_grid_follows_from_the_shape():
    """A tile a SLOT_TILE_ROWS plan positions, and none when there are
    none: the grid needs no read of the device.  The scratch holds two rows
    a tile (a tile holds at most two chunk starts)."""
    R = cuda_ops.SLOT_TILE_ROWS
    assert R == 256 and cuda_ops.SLOT_SEQ_ROWS == 64
    assert [cuda_ops.slot_reduce_tiles(E) for E in (0, 1, R - 1, R, R + 1, 19792, 6_240_488)] == [
        0, 1, 1, 1, 2, 78, 24_377]


@pytest.mark.parametrize("E,C,itemsize,address,layout", [
    (19792, 36, 4, 0, (16, 8, 2, 1)),        # sphere2500's blocks: nine 16-byte units, 8 lanes of 2
    (9896, 6, 4, 0, (8, 4, 1, 1)),           # gradient rows: 24 bytes, three 8-byte units
    (4_650_850, 9, 4, 0, (4, 8, 2, 14)),     # config 6 by landmark: 36 bytes, 4-byte units, 128 KB a block
    (19792, 81, 4, 0, (4, 32, 4, 1)),        # the chordal rotation assembly: 81 units, 32 lanes of up to 3
    (6_240_488, 36, 4, 0, (16, 8, 2, 3)),    # a pair plan of config 6
    (6_240_488, 36, 4, 4, (4, 32, 2, 3)),    # ... a view off the 16-byte grid: 36 units
    (6_240_488, 36, 4, 8, (8, 16, 2, 3)),    # ... on the 8-byte grid
    (4_650_850, 6, 4, 0, (8, 4, 1, 21)),     # config 6 by camera, width 6
    (200_000, 6, 4, 0, (8, 4, 1, 2)),        # no more than two blocks an SM's worth of tiles
    (200_000, 36, 8, 0, (16, 16, 2, 1)),
    (200_000, 27, 8, 8, (8, 32, 1, 2)),
    (10**8, 3, 4, 0, (4, 4, 1, 42)),
    (1000, 600, 4, 0, (16, 32, 4, 1)),       # 150 units: 128 a walk of the segment, then 22
    (10**8, 1, 8, 8, (8, 1, 1, 64)),
    (0, 5, 4, 0, (4, 4, 2, 1)),
])
def test_slot_reduce_layout(E, C, itemsize, address, layout):
    """The unit is the widest of 16 and 8 bytes that divides the row and
    its address, else the value's own size; a sub-warp of the lanes that
    the sub-warp kernel's rule gave the row's units, each lane holding 1, 2
    or 4 units; about 128 KB of rows a block of chunks, while that leaves
    at least 264 such blocks."""
    unit, lanes, per_lane, group = cuda_ops.slot_reduce_layout(E, C, itemsize, address)
    assert (unit, lanes, per_lane, group) == layout
    assert C * itemsize % unit == 0 and address % unit == 0 and 32 % lanes == 0
    assert 1 <= group <= 64 and (group == 1 or group * cuda_ops.SLOT_TILE_ROWS * C * itemsize <= 1 << 17)


def test_tiled_slot_sum_models_the_kernel_order():
    """The host model of the kernel's order that the card's tests hold it to:
    the plain version's sums; a segment of at most SLOT_SEQ_ROWS rows with
    the bits of the sequential sum; a longer one of at most SLOT_TILE_ROWS
    rows as J = 8 strided sums added in order; a longer one still with the
    bits of its chunks' sums added in order, each chunk so."""
    R, S, J = cuda_ops.SLOT_TILE_ROWS, cuda_ops.SLOT_SEQ_ROWS, CHUNK_STRIDE
    assert (R, S, J) == (256, 64, 8)
    rng = np.random.default_rng(3)
    sizes = np.concatenate([[5 * R + 3, R - 1, R, R + 1, S, S + 1, 0, 0], rng.integers(0, 6, 300)])
    rng.shuffle(sizes)
    n_slots = len(sizes)
    dest = np.repeat(np.arange(n_slots), sizes)
    rng.shuffle(dest)
    plan = slot_plan(dest, n_slots)
    contrib = torch.from_numpy(rng.normal(size=(len(dest), 5)).astype(np.float32))
    perm, offsets = _t(plan.perm), _t(plan.offsets)
    model = tiled_slot_sum(contrib, perm, offsets, n_slots, R, S)
    ref = slot_reduce_plain(contrib, perm, offsets, n_slots)
    assert (model - ref).abs().max() <= 1e-5 * ref.abs().max()
    short = torch.from_numpy(sizes <= S)
    assert torch.equal(model[short], sequential_slot_sum(contrib, perm, offsets, n_slots)[short])

    def strided(rows):
        acc = torch.zeros(5)
        for j in range(J):
            part = torch.zeros(5)
            for row in rows[j::J]:
                part = part + row
            acc = acc + part
        return acc

    for size in (S + 1, R):
        (s,) = np.flatnonzero(sizes == size)
        assert torch.equal(model[s], strided(contrib[perm[plan.offsets[s]:plan.offsets[s + 1]].long()]))
    (s,) = np.flatnonzero(sizes == 5 * R + 3)
    rows = contrib[perm[plan.offsets[s]:plan.offsets[s + 1]].long()]
    acc = torch.zeros(5)
    for k in range(6):
        acc = acc + strided(rows[k * R:(k + 1) * R])
    assert torch.equal(model[s], acc)


def test_slot_plan_notes_the_longest_segment():
    """A plan's longest segment is noted where the plan is built, from the
    host array, and travels with the plan to ``slot_reduce``: on
    ``SlotPlan``, ``Segments``, ``DenseGroup`` and ``EllDevicePlan``."""
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth as tsynth
    from pyslam_tpu_torch.solver import assemble, bcsr
    from pyslam_tpu_torch.solver.schur_large import _segments

    plan = slot_plan(np.array([0, 0, 0, 2, 2, 3]), 5)
    assert plan.longest == 3 == cuda_ops.slot_longest(plan.offsets)
    assert slot_plan(np.zeros(0, np.int64), 4).longest == 0 == cuda_ops.slot_longest(np.zeros(5, np.int32))
    assert slot_plan(np.zeros(0, np.int64), 0).longest == 0 == cuda_ops.slot_longest(np.zeros(1, np.int32))
    seg = _segments(np.array([1, 1, 0, 1]), 3, "cpu")
    assert seg.longest == 3 and seg.offsets.tolist() == [0, 1, 4, 4]
    g = build.pose_graph(tsynth.se3_sphere(n_poses=30, seed=0), dtype=torch.float64, device="cpu")
    d_plan = assemble.dense_plan(g)
    for grp in d_plan.h_groups + d_plan.g_groups:
        assert grp.longest == int(np.diff(grp.offsets.numpy()).max())
    dplan = bcsr.ell_device_plan(bcsr.build_ell_direct(g), "cpu")
    assert dplan.h_longest == cuda_ops.slot_longest(dplan.h_offsets.numpy())
    assert dplan.g_longest == cuda_ops.slot_longest(dplan.g_offsets.numpy())


# (E, n_slots, C, longest, body) at the shapes of PERF.md's kernel table
@pytest.mark.parametrize("E,n_slots,C,longest,body", [
    (19792, 22500, 36, 8, "subwarps"),        # sphere2500's Hessian blocks
    (9896, 2500, 6, 8, "subwarps"),           # ... gradient rows
    (19792, 22500, 81, 8, "subwarps"),        # the chordal rotation assembly
    (4_650_850, 1_000_000, 9, 5, "subwarps"),  # config 6 by landmark
    (4453, 250, 4, 20, "subwarps"),           # config 8's window
    (25769, 49, 36, 610, "block"),            # config 4 by camera: chain 22 rows
    (25769, 49, 6, 610, "block"),             # ... 4 rows
    (22500, 172, 36, 1056, "block"),          # two-level A_c: 38 rows
    (2500, 20, 6, 125, "block"),              # two-level r_c: the old rule's block
    (331_635, 300, 27, 2345, "block"),        # Venice-mini by camera: 64 rows
    (331_635, 300, 36, 2345, "tiles"),        # ... 84 rows
    (112_000, 128, 36, 6758, "tiles"),        # the square-root path's camera pairs
    (4_650_850, 1700, 6, 23016, "tiles"),     # config 6 by camera
    (6_240_488, 17076, 36, 18576, "tiles"),   # config 6's cluster pair plan
    (6_240_488, 17076, 36, None, "tiles"),    # no longest: the body that sums any plan
    (100, 1, 3, 100, "block"),                # one segment of 100 rows: the old rule's block
    (300, 10, 3, 100, "subwarps"),            # 30 rows a destination on average: the old rule's sub-warps
    (0, 4, 6, 0, "subwarps"),
    (5_001_946, 993_923, 3, 1765, "tiles"),       # Venice by landmark: chain 6 rows, 5 rows a destination
    (5_001_946, 993_923, 9, 1765, "tiles"),       # ... chain 16 rows
    (28_987_644, 4_456_117, 3, 13_682, "tiles"),  # BAL Final by landmark: chain 41 rows
    (28_987_644, 4_456_117, 9, 13_682, "tiles"),  # ... chain 122 rows
    (64_000, 1000, 3, 300, "block"),              # 64 rows a destination: few destinations
    (63_999, 1000, 3, 300, "tiles"),              # one row fewer: the tiles
    (262_144, 2048, 6, 1765, "block"),            # past 1,024 destinations: n_slots^2 / 16 rows
    (262_143, 2048, 6, 1765, "tiles"),
    (1280, 100, 6, 1080, "block"),                # a fixed-lag window's sums: one wave of blocks, chain 7 rows
    (1600, 58, 9, 1505, "block"),                 # ... chain 14 rows
    (2400, 404, 36, 1677, "tiles"),               # fixed-lag sphere2500's Hessian blocks: two waves
    (1280, 264, 6, 1080, "block"),                # one wave: 264 destinations
    (1280, 265, 6, 1080, "tiles"),                # one more: two waves
    (4000, 100, 6, 2720, "block"),                # one wave, chain 16 rows
    (4000, 100, 6, 2721, "tiles"),                # ... 17 rows
    (9437, 501, 3, 7972, "tiles"),                # incremental M3500's last landmark sums: two waves (in f64 the
                                                  # block is faster here, 9.4 against 13.8 us; not in f32)
])
def test_slot_reduce_body(E, n_slots, C, longest, body):
    """The body follows from the shape and the plan's longest segment: the
    old rule's choice where every segment has at most SLOT_TILE_ROWS rows,
    past that the block for few destinations (the old rule's test) whose
    longest chain has at most SLOT_BLOCK_DEPTH rows, else the tiles."""
    assert cuda_ops.slot_reduce_body(E, n_slots, C, longest) == body


@pytest.mark.parametrize("longest,C,depth", [(610, 36, 22), (610, 6, 4), (2345, 27, 64), (2345, 36, 84),
                                             (6758, 6, 40), (10, 1500, 20), (0, 9, 0)])
def test_slot_block_depth(longest, C, depth):
    """ceil(longest / (1024 // C)) rows a thread, again for each 1024
    columns past 1024."""
    assert cuda_ops.slot_block_depth(longest, C) == depth


@pytest.mark.parametrize("C", [6, 36, 600, 1500])
def test_block_slot_sum_models_the_block_order(C):
    """The host model of the block body: the plain version's sums, and a
    segment's bits those of Rb strided partial sums met pairwise."""
    rng = np.random.default_rng(4)
    sizes = np.array([700, 0, 3, 1, 1200, 40])
    n_slots = len(sizes)
    dest = np.repeat(np.arange(n_slots), sizes)
    rng.shuffle(dest)
    plan = slot_plan(dest, n_slots)
    contrib = torch.from_numpy(rng.normal(size=(len(dest), C)).astype(np.float32))
    perm, offsets = _t(plan.perm), _t(plan.offsets)
    model = block_slot_sum(contrib, perm, offsets, n_slots)
    ref = slot_reduce_plain(contrib, perm, offsets, n_slots)
    assert (model - ref).abs().max() <= 1e-5 * ref.abs().max()
    Rb = max(1024 // C, 1)
    rows = contrib[perm[plan.offsets[4]:plan.offsets[5]].long()]
    partial = [torch.zeros(C) for _ in range(Rb)]
    for e in range(len(rows)):
        partial[e % Rb] = partial[e % Rb] + rows[e]
    h = 1
    while 2 * h < Rb:
        h *= 2
    while Rb > 1 and h >= 1:
        for r in range(min(h, Rb - h)):
            partial[r] = partial[r] + partial[r + h]
        h //= 2
    assert torch.equal(model[4], partial[0])
    assert torch.equal(slot_reduce_model(contrib, perm, offsets, n_slots, plan.longest),
                       model if cuda_ops.slot_reduce_body(len(dest), n_slots, C, plan.longest) == "block"
                       else tiled_slot_sum(contrib, perm, offsets, n_slots, 256, 64))


def test_slot_reduce_of_nothing_is_zero():
    """E = 0 (a graph without the factors a sum is over): every slot 0."""
    out = slot_reduce(torch.zeros((0, 6), dtype=torch.float64), torch.zeros(0, dtype=torch.int32),
                      torch.zeros(5, dtype=torch.int32), 4)
    assert out.shape == (4, 6) and not out.any()
    out = slot_reduce(torch.zeros((0, 6), dtype=torch.float64), torch.zeros(0, dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32), 0)
    assert out.shape == (0, 6)


# --------------------------------------------------------------------------
# Wrapper dispatch and checks
# --------------------------------------------------------------------------


def test_cpu_tensors_run_the_plain_versions():
    cuda_ops.reset_launches()
    He, cols, x = _random_ell(8, 3, 6, seed=1)
    ell_matvec(_t(He), _t(cols), _t(x))
    plan = slot_plan(np.array([0, 1, 1]), 2)
    slot_reduce(torch.ones(3, 36, dtype=torch.float64), _t(plan.perm), _t(plan.offsets), 2)
    one = torch.ones(1, dtype=torch.float64)
    cost, rows = cuda_ops.bal_rows(torch.eye(4, dtype=torch.float64)[None], torch.tensor([[0.1, 0.2, -5.0]]).double(),
                                   torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64),
                                   torch.zeros(1, 2, dtype=torch.float64), 500.0 * one, 0.0 * one, 0.0 * one,
                                   torch.eye(2, dtype=torch.float64), one, L2Loss())
    assert cost.shape == (1,) and rows.shape == (1, 54)
    assert cuda_ops.LAUNCHES == {
        "ell_matvec": 0, "ell_matvec_plain": 1, "ell_pcg": 0, "ell_pcg_plain": 0,
        "slot_reduce": 0, "slot_reduce.tiles": 0, "slot_reduce.subwarps": 0, "slot_reduce.block": 0,
        "slot_reduce_plain": 1, "ell_assemble": 0, "ell_assemble_plain": 0,
        "bal_rows": 0, "bal_rows9": 0, "bal_rows_plain": 1,
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
