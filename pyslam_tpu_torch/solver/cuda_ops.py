"""Hand-written CUDA kernels for the block-sparse hot ops, with their plain
PyTorch versions and launch counters.

Counterpart of ``pyslam_tpu/solver/pallas_ops.py``:

* ``ell_matvec`` (``csrc/ell_matvec.cu``) replaces ``ell_matvec_lane_major``
  / ``ell_matvec_pallas``: the symmetric-ELL block SpMV, y[r] = sum_k
  He[r, k] @ x[cols[r, k]] (dogleg's model products on ``solve_ell``).
* ``ell_pcg`` (``csrc/ell_pcg.cu``) is that product at the grain this card
  wants it: the whole block-Jacobi PCG solve of ``solve_ell`` (the
  reference's ``_pcg`` ``while_loop`` around ``ell_matvec_lane_major``) as
  one persistent launch, with He resident in shared memory; and, for the
  columns of a covariance query (the reference's vmap of that loop), a
  block of right-hand sides in one launch, each column with its own stop
  test.
* ``slot_reduce`` (``csrc/slot_reduce.cu``) replaces ``scatter_matmul``: the
  reduction of per-factor contributions into their destination blocks (and
  of the gradient rows into their rows) during assembly, as a deterministic
  segmented sum over a plan sorted by destination.
* ``ell_assemble`` (``csrc/ell_assemble.cu``) is that reduction at the grain
  this card wants it: the whole ``assemble_ell`` of an SE(3) pose graph
  (linearization of every ``between_se3`` / ``prior_se3`` factor, the
  ordered sums into the ELL slots, the masks, the gradient and chi2) in two
  programmatic dependent launches: a team of lanes a factor, then a warp a
  pose row that stages each incident factor's record once, forms its blocks
  and sums every slot of its row in the plan's order.
* ``bal_rows`` (``csrc/bal_rows.cu``) replaces no Pallas kernel: the rows of
  ``schur_large``'s linearization of monocular BAL observations (the
  ``reprojection_bal`` factor kernel on se3 poses, or ``reprojection_bal9``
  on 9-parameter bal_cam9 cameras, its loss weights and the products
  J^T w r and J^T diag(w) J that the Schur sums read) in one launch, where
  the factor kernel's tensor ops took about 70 launches a chunk.

Dispatch: a tensor on the CPU goes to the plain version (the CPU tests use
it); a tensor on a CUDA device launches the kernel or raises.  There is no
fallback from the kernel to the plain version.  ``LAUNCHES`` counts, for
each function, the calls that ran it, and ``slot_reduce``'s also by the
body each ran (``"slot_reduce.tiles"``, ``".subwarps"``, ``".block"``);
``pcg_iterations`` reads the CG iterations (over all columns) that
``ell_pcg`` launches summed on the device.  The source note
of each kernel says what bounds it on an H100 and what its design does
about that.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import losses as _losses
from ..lie import se3
from . import linear

LAUNCHES = {
    "ell_matvec": 0, "ell_matvec_plain": 0,
    "ell_pcg": 0, "ell_pcg_plain": 0,
    "slot_reduce": 0, "slot_reduce.tiles": 0, "slot_reduce.subwarps": 0, "slot_reduce.block": 0,
    "slot_reduce_plain": 0,
    "ell_assemble": 0, "ell_assemble_plain": 0,
    "bal_rows": 0, "bal_rows9": 0, "bal_rows_plain": 0,
}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# Per CUDA device, a one-element int64 tensor to which every ell_pcg launch
# adds its iteration count, on the device.
_PCG_ITERATIONS: dict = {}


def reset_launches():
    """Every launch count, and the device counters of CG iterations, to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counter in _PCG_ITERATIONS.values():
        counter.zero_()


def pcg_iterations() -> int:
    """CG iterations run by the ``ell_pcg`` kernel since the last
    ``reset_launches()``, over all devices.  One device-to-host read per
    device: for the end of a run, not for a solver loop."""
    return sum(int(counter.item()) for counter in _PCG_ITERATIONS.values())


def _route(*tensors) -> str:
    """'cpu' or 'cuda' for tensors that all share one device; raises else."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _raise_on_error(fn_name, err):
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")


# --------------------------------------------------------------------------
# ELL block SpMV
# --------------------------------------------------------------------------


def ell_matvec_plain(He, cols, x):
    """Plain version: gather + batched contraction."""
    LAUNCHES["ell_matvec_plain"] += 1
    d = He.shape[2]
    xg = x.reshape(-1, d)[cols]  # (nb, K, d)
    return torch.einsum("rkij,rkj->ri", He, xg).reshape(-1)


def ell_matvec(He, cols, x):
    """y (nb*d,) = sum_k He[r, k] @ x[cols[r, k]] for He (nb, K, d, d)
    contiguous, cols (nb, K) int32 and x (n_x*d,) with cols in [0, n_x).
    n_x is nb for the product of a whole matrix; a rank of a sharded solve
    (``dist/pose_sharded.py``) multiplies its nb rows by the x of every
    rank.  The range of cols is the caller's to check on the host, when it
    builds them."""
    if He.dim() != 4 or He.shape[2] != He.shape[3]:
        raise ValueError(f"He: shape {tuple(He.shape)}, expected (nb, K, d, d)")
    nb, K, d, _ = He.shape
    if He.dtype not in _SUFFIX:
        raise TypeError(f"He: dtype {He.dtype}, expected float32 or float64")
    _check("He", He, He.dtype, (nb, K, d, d))
    _check("cols", cols, torch.int32, (nb, K))
    if x.dim() != 1 or d == 0 or x.shape[0] % d:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (n_x * {d},)")
    _check("x", x, He.dtype, (x.shape[0],))
    if _route(He, cols, x) == "cpu":
        return ell_matvec_plain(He, cols, x)
    from .._ext import library

    y = x.new_empty(nb * d)
    fn_name = f"pyslam_ell_matvec_{_SUFFIX[He.dtype]}"
    err = getattr(library(), fn_name)(
        He.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(), nb, K, d,
        torch.cuda.current_stream(He.device).cuda_stream,
    )
    _raise_on_error(fn_name, err)
    LAUNCHES["ell_matvec"] += 1
    return y


# --------------------------------------------------------------------------
# Block-Jacobi PCG on the ELL matrix
# --------------------------------------------------------------------------


class PcgResult(NamedTuple):
    x: torch.Tensor  # (nb*d,), or (nb*d, m) for a block of right-hand sides
    iterations: torch.Tensor  # int32 on x's device: 0-dim, or (m,) one count a column
    # Block rows (of nb) whose He, cols and Minv the kernel kept in shared
    # memory for the whole solve (the fewest over the launches of a block);
    # the others were read from device memory every iteration.  None from
    # the plain version.
    resident_rows: int | None


_PCG_ERRORS = {
    -1: "the device does not support cooperative launch",
    -2: "the solve's vectors do not fit in shared memory (nb * d too large for this kernel)",
    -3: "the grid cannot be co-resident with this much shared memory",
    -4: "more columns than one launch carries (ell_pcg_plan's max_columns)",
    -5: "the grid is larger than the carrying barrier's slots (160 blocks)",
}
_PCG_PLANS: dict = {}


def ell_pcg_plan(nb, K, d, dtype, device, columns=1) -> dict:
    """The launch geometry of ``ell_pcg`` for these shapes and ``columns``
    right-hand sides a launch on ``device``, as the library computes it:
    ``grid`` (blocks, one per SM at most), ``rows_per_block``,
    ``resident_rows`` (of nb), ``smem_bytes`` (dynamic shared memory a
    block), ``lanes`` (sub-warp width of a row product) and
    ``max_columns``, the most right-hand sides one launch carries (as many
    as fit in shared memory beside a fully resident He; 1 where He does not
    fit with even one)."""
    from .._ext import library

    device = torch.device(device)
    key = (nb, K, d, dtype, device, columns)
    if key not in _PCG_PLANS:
        out = (ctypes.c_int * 6)()
        with torch.cuda.device(device):
            err = library().pyslam_ell_pcg_plan(nb, K, d, torch.finfo(dtype).bits // 8, columns, out)
        _raise_on_pcg_error("pyslam_ell_pcg_plan", err)
        _PCG_PLANS[key] = dict(zip(("grid", "rows_per_block", "resident_rows", "smem_bytes", "lanes", "max_columns"),
                                   out))
    return _PCG_PLANS[key]


def _raise_on_pcg_error(fn_name, err):
    if err < 0:
        raise RuntimeError(f"{fn_name}: {_PCG_ERRORS.get(err, err)}")
    _raise_on_error(fn_name, err)


def _ell_matvec_columns(He, cols, X):
    """The plain ELL product of every column of X (nb*d, m)."""
    nb, _, d, _ = He.shape
    xg = X.reshape(nb, d, -1)[cols.long()]  # (nb, K, d, m)
    return torch.einsum("rkij,rkjm->rim", He, xg).reshape(nb * d, -1)


def ell_pcg_plain(He, cols, Minv, b, rtol, max_iters):
    """Plain version.  One right-hand side: ``linear.pcg_solve`` (the host
    loop, one stop test read back per iteration) over ``ell_matvec_plain``
    and the batched ``Minv @ r``.  A block (nb*d, m): ``schur_large._pcg``
    on the columns (the same recurrences for every column at once, each
    with its own stop test, a column frozen from the iteration its test
    fails: the reference's vmap of ``pcg_solve``), the host reading the m
    tests before every iteration and stopping when none runs."""
    LAUNCHES["ell_pcg_plain"] += 1
    nb, _, d, _ = He.shape

    if b.dim() == 1:
        def precond(r):
            return (Minv @ r.reshape(nb, d, 1)).reshape(-1)

        x, it = linear.pcg_solve(
            lambda v: ell_matvec_plain(He, cols, v), b, precond=precond, rtol=rtol, max_iters=max_iters
        )
        return PcgResult(x, torch.tensor(it, dtype=torch.int32, device=b.device), None)

    from .schur_large import _pcg  # schur_large imports this module

    def precond_cols(R):
        return (Minv @ R.reshape(nb, d, -1)).reshape(nb * d, -1)

    X, its = _pcg(lambda P: _ell_matvec_columns(He, cols, P), precond_cols, b, rtol, max_iters, read_every=1)
    return PcgResult(X, its.to(torch.int32), None)


def ell_pcg(He, cols, Minv, b, rtol, max_iters):
    """Solve A x = b by block-Jacobi preconditioned CG from x0 = 0, where
    (A v)[r] = sum_k He[r, k] @ v[cols[r, k]] and the preconditioner is
    z[r] = Minv[r] @ r[r]: ``linear.pcg_solve``'s recurrences and stop rule
    (continue while ``norm(r) > rtol * norm(b)`` and ``it < max_iters``,
    tested before every iteration; a NaN ends the loop).

    He (nb, K, d, d), cols (nb, K) int32 with entries in [0, nb), Minv
    (nb, d, d), b (nb*d,) or a block of m right-hand sides (nb*d, m), all
    contiguous on one device.  Each column of a block runs its own
    recurrences and stop test and is frozen once that fails, as the
    reference's vmap of ``pcg_solve`` over the columns.  Returns a
    ``PcgResult``: x of b's shape, ``iterations`` 0-dim or (m,).  On a CUDA
    device a block is one launch per ``ell_pcg_plan(...)["max_columns"]``
    columns, and no host read.  The kernel takes r0 = b without forming A @
    x0; the two differ only where He holds a non-finite value
    (``pcg_solve`` then stops at once with x = 0, the kernel returns NaN
    after one iteration: LM rejects either step)."""
    if He.dim() != 4 or He.shape[2] != He.shape[3]:
        raise ValueError(f"He: shape {tuple(He.shape)}, expected (nb, K, d, d)")
    nb, K, d, _ = He.shape
    if He.dtype not in _SUFFIX:
        raise TypeError(f"He: dtype {He.dtype}, expected float32 or float64")
    _check("He", He, He.dtype, (nb, K, d, d))
    _check("cols", cols, torch.int32, (nb, K))
    _check("Minv", Minv, He.dtype, (nb, d, d))
    if b.dim() not in (1, 2):
        raise ValueError(f"b: shape {tuple(b.shape)}, expected ({nb * d},) or ({nb * d}, m)")
    _check("b", b, He.dtype, (nb * d,) + tuple(b.shape[1:]))
    rtol, max_iters = float(rtol), int(max_iters)
    if max_iters < 0:
        raise ValueError(f"max_iters: {max_iters}, expected >= 0")
    if _route(He, cols, Minv, b) == "cpu":
        return ell_pcg_plain(He, cols, Minv, b, rtol, max_iters)
    dev = b.device
    n = nb * d
    m = 1 if b.dim() == 1 else b.shape[1]
    cap = ell_pcg_plan(nb, K, d, He.dtype, dev)["max_columns"]
    with torch.cuda.device(dev):
        B = b.reshape(n, m)
        X = torch.empty_like(B)
        iterations = torch.empty(m, dtype=torch.int32, device=dev)
        resident = nb
        for s in range(0, m, cap):
            mc = min(cap, m - s)
            plan = ell_pcg_plan(nb, K, d, He.dtype, dev, mc)
            resident = min(resident, plan["resident_rows"])
            # the kernel's layout: (n, mp), the columns padded to whole 16 bytes
            mp = pcg_layout_columns(mc, He.dtype)
            whole = mc == mp == m and (m == 1 or B.data_ptr() % 16 == 0)
            if whole:
                bk, xk = B, X
            else:
                bk = B.new_zeros((n, mp))
                bk[:, :mc] = B[:, s:s + mc]
                xk = B.new_empty((n, mp))
            scratch = torch.empty(pcg_scratch_values(n, mp, plan["grid"], He.dtype), dtype=He.dtype, device=dev)
            ell_pcg_launch(He, cols, Minv, bk, xk, scratch, iterations[s:s + mc], rtol, max_iters)
            if not whole:
                X[:, s:s + mc] = xk[:, :mc]
    if b.dim() == 1:
        return PcgResult(X.reshape(n), iterations[0], resident)
    return PcgResult(X, iterations, resident)


def ell_pcg_launch(He, cols, Minv, bk, xk, scratch, iterations, rtol, max_iters):
    """One launch of the ``ell_pcg`` kernel on CUDA tensors, the caller's
    scratch included (the kernel clears what it needs of it): mc =
    ``iterations.numel()`` columns, at most the plan's ``max_columns``, b
    and x in the kernel's layout (nb*d, ``pcg_layout_columns(mc)``), b's
    padding columns zero, and ``pcg_scratch_values`` values of scratch.
    Counts the launch; the checks of shapes are ``ell_pcg``'s."""
    from .._ext import library

    nb, K, d, _ = He.shape
    dev = He.device
    if dev not in _PCG_ITERATIONS:
        _PCG_ITERATIONS[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    fn_name = f"pyslam_ell_pcg_{_SUFFIX[He.dtype]}"
    err = getattr(library(), fn_name)(
        He.data_ptr(), cols.data_ptr(), Minv.data_ptr(), bk.data_ptr(), xk.data_ptr(), scratch.data_ptr(),
        iterations.data_ptr(), _PCG_ITERATIONS[dev].data_ptr(), nb, K, d, iterations.numel(), rtol, max_iters,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_pcg_error(fn_name, err)
    LAUNCHES["ell_pcg"] += 1


def pcg_layout_columns(m, dtype) -> int:
    """Columns of ``ell_pcg``'s layout for a launch of m: 1 for one column,
    else m rounded up to whole 16 bytes (b and x as (n, mp), the padding
    zero)."""
    per = 128 // torch.finfo(dtype).bits
    return 1 if m == 1 else -(-m // per) * per


def pcg_scratch_values(n, mp, grid, dtype) -> int:
    """Values of ``ell_pcg``'s scratch for n = nb*d, mp layout columns, the
    plan's grid and the values' dtype: the two carrying barriers' slots and
    column totals (2 mp (grid + 1) lines of 128 bytes), the prologue's
    partial sums (grid, mp, 2), p of two iterations and z, (n, mp) each,
    twice that for one column (each value tagged with its iteration)."""
    tagged = 2 if mp == 1 else 1
    return 256 // (torch.finfo(dtype).bits // 8) * (grid + 1) * mp + 2 * grid * mp + 3 * tagged * n * mp


# --------------------------------------------------------------------------
# Segmented slot reduction
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """Contributions sorted stably by destination: contribution ``perm[e]``
    is the e-th to add, and slot s sums ``[offsets[s], offsets[s+1])``."""

    perm: np.ndarray  # (E,) int32
    offsets: np.ndarray  # (n_slots + 1,) int32
    n_slots: int
    longest: int  # the rows of the longest segment (0 without rows)


def _stable_argsort(dest, n_slots):
    """``np.argsort(dest, kind="stable")`` for destinations in [0, n_slots).
    numpy sorts 16-bit keys by radix, ten times faster than its merge sort
    of wider ones, so the keys go 16 bits at a time, low half first."""
    if n_slots <= 1 << 16:
        return np.argsort(dest.astype(np.uint16), kind="stable")
    if n_slots > 1 << 32:
        return np.argsort(dest, kind="stable")
    low = np.argsort((dest & 0xFFFF).astype(np.uint16), kind="stable")
    return low[np.argsort((dest[low] >> 16).astype(np.uint16), kind="stable")]


def slot_plan(dest: np.ndarray, n_slots: int) -> SlotPlan:
    """The ``slot_reduce`` plan of contributions with destinations ``dest``
    (host, numpy); raises on a destination outside [0, n_slots)."""
    dest = np.asarray(dest, np.int64)
    if len(dest) and (dest.min() < 0 or dest.max() >= n_slots):
        raise ValueError(f"slot destination out of range [0, {n_slots})")
    if len(dest) >= 2**31:
        raise ValueError("too many contributions for int32 offsets")
    perm = _stable_argsort(dest, n_slots).astype(np.int32)
    counts = np.bincount(dest, minlength=n_slots)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return SlotPlan(perm, offsets, n_slots, int(counts.max()) if n_slots else 0)


def _segment_ids(offsets, n_slots, E=None):
    """The destination of every position of a plan: s for [offsets[s],
    offsets[s+1]).  With ``E``, the number of positions, no host read."""
    counts = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(torch.arange(n_slots, device=offsets.device), counts, output_size=E)


def slot_reduce_plain(contrib, perm, offsets, n_slots):
    """Plain version: index_add_ of the permuted contributions into their
    segment ids."""
    LAUNCHES["slot_reduce_plain"] += 1
    out = torch.zeros((n_slots, contrib.shape[1]), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, _segment_ids(offsets, n_slots), contrib[perm.long()])


# The kernel's grain (csrc/slot_reduce.cu says why): its unit kernel sums a
# segment of at most SLOT_SEQ_ROWS rows in plan order by a sub-warp of its
# own (the bits of the sequential sum), a longer one by the tiles of
# SLOT_TILE_ROWS plan positions (the .cu file's kTileRows; read here, not
# set), whole up to SLOT_TILE_ROWS rows and past that in chunks of that many
# rows whose sums are then added in chunk order.
SLOT_SEQ_ROWS = 64
SLOT_TILE_ROWS = 256

# Where a plan's longest segment is known (``slot_reduce(..., longest=)``),
# two more bodies take the shapes where they were measured faster
# (``slot_reduce_body``): a sub-warp a segment with the width a template
# parameter, and a block of SLOT_BLOCK_THREADS threads a destination, for
# few destinations: at least LONG_MIN_ROWS * max(1, n_slots / LONG_SLOTS)
# rows a destination on average.  Plans whose segments all have at most
# SLOT_TILE_ROWS rows keep the choice that this test made between the block
# and sub-warps before the unit kernel came, and with it their bits.  A
# plan with a longer segment takes the block only where its longest chain
# of rows is also at most SLOT_BLOCK_DEPTH, else the tiles: a skewed plan
# of many short segments and a few long ones (BAL's sums by landmark:
# 993,923 destinations of 5 rows on average, the longest 1,765) would
# otherwise launch a block of 1,024 threads for each 2- or 3-row
# destination.  Its blocks run SLOT_RESIDENT_BLOCKS at a time (2 of 1,024
# threads on each of the H100's 132 SMs), so a plan of at most that many
# destinations is one wave of them: there the block also takes a plan of
# many short segments whose longest chain is at most SLOT_WAVE_DEPTH rows
# (the fixed-lag windows' sums: about 100 destinations, one of 1,000 rows
# or more, the others of 1 to 3).
SLOT_BLOCK_THREADS = 1024
SLOT_BLOCK_DEPTH = 64
SLOT_RESIDENT_BLOCKS = 264
SLOT_WAVE_DEPTH = 16
LONG_SLOTS = 1024
LONG_MIN_ROWS = 64
_BODY = {"tiles": 0, "subwarps": 1, "block": 2}

# Per (device, stream), int32 zeros: the kernel's arrival counters, one a
# tile; the kernel puts every counter it uses back to 0.
_SLOT_ARRIVALS: dict = {}


def slot_longest(offsets) -> int:
    """The rows of a plan's longest segment, from its offsets on the host
    (numpy): what ``slot_reduce``'s ``longest`` takes, computed once where
    the plan is built."""
    offsets = np.asarray(offsets)
    return int(np.diff(offsets).max()) if len(offsets) > 1 else 0


def slot_block_depth(longest: int, C: int) -> int:
    """The rows that the block kernel's thread of the longest segment adds
    one after the other: it keeps SLOT_BLOCK_THREADS // C rows in flight
    (one past SLOT_BLOCK_THREADS columns, which it walks again for each
    SLOT_BLOCK_THREADS of them)."""
    cols = min(C, SLOT_BLOCK_THREADS)
    return -(-longest // (SLOT_BLOCK_THREADS // cols)) * -(-C // cols)


def slot_reduce_body(E: int, n_slots: int, C: int, longest) -> str:
    """The body ``slot_reduce`` sums a plan of E rows into n_slots
    destinations of C values with: "tiles" (the unit kernel with its tile
    blocks: any plan, the only body when ``longest`` is None), "subwarps"
    (a sub-warp a segment, in plan order) or "block" (a block a
    destination).  Few destinations: at least LONG_MIN_ROWS * max(1,
    n_slots / LONG_SLOTS) rows a destination on average.  Segments of at
    most SLOT_TILE_ROWS rows: the block for few destinations, else
    sub-warps.  Longer ones, whose longest chain is ``slot_block_depth``:
    the block for few destinations with a chain of at most
    SLOT_BLOCK_DEPTH rows, or for one wave of blocks (at most
    SLOT_RESIDENT_BLOCKS destinations) with a chain of at most
    SLOT_WAVE_DEPTH rows; else the tiles.  The plan and C alone decide, so
    one plan always sums in one order."""
    if longest is None:
        return "tiles"
    few = E * LONG_SLOTS >= LONG_MIN_ROWS * n_slots * max(n_slots, LONG_SLOTS)
    if longest <= SLOT_TILE_ROWS:
        return "block" if few else "subwarps"
    depth = slot_block_depth(longest, C)
    one_wave = n_slots <= SLOT_RESIDENT_BLOCKS and depth <= SLOT_WAVE_DEPTH
    return "block" if (few or one_wave) and depth <= SLOT_BLOCK_DEPTH else "tiles"


def slot_reduce_tiles(E: int) -> int:
    """The kernel's tiles for a plan of E positions: ceil(E /
    SLOT_TILE_ROWS), ``group`` a block (``slot_reduce_layout``) beside the
    blocks of the short segments.  Its scratch holds two rows a tile
    (``slot_reduce`` allocates (2 tiles, C)): a tile holds the starts of at
    most two chunks."""
    return -(-E // SLOT_TILE_ROWS)


def _slot_lanes(units: int) -> int:
    """Lanes a short segment's sub-warp takes for a row of ``units`` units:
    the power of two below it, or the one above when that would leave lanes
    with more than a quarter of extra work; 32 at most."""
    p = 1
    while p < 32 and 2 * p <= units:
        p *= 2
    return 2 * p if p < 32 and 4 * units > 5 * p else p


def slot_reduce_layout(E: int, C: int, itemsize: int, address: int) -> tuple:
    """(unit, lanes, units a lane, group) of the kernel for a plan of E rows
    of C values of ``itemsize`` bytes whose first row is at ``address``:
    the bytes of one load or store (16, 8 or the value's own: the widest
    that divides the row and the address); the lanes of a short segment's
    sub-warp and the units each lane holds (1, 2 or 4; a wider row is
    walked again for the units past lanes x 4); the tiles a block of the
    long segments' chunks takes: about 128 KB of rows, 64 tiles at most,
    and no more than leave two such blocks for each of the card's 132
    SMs."""
    row = C * itemsize
    unit = next(u for u in (16, 8, itemsize) if u >= itemsize and row % u == 0 and address % u == 0)
    units = row // unit
    lanes = _slot_lanes(units)
    per_lane = -(-units // lanes)
    group = max(1, min(64, (1 << 17) // (SLOT_TILE_ROWS * row), slot_reduce_tiles(E) // 264))
    return unit, lanes, 1 if per_lane <= 1 else 2 if per_lane <= 2 else 4, group


def _slot_arrivals(device, stream, tiles):
    key = (device, stream.cuda_stream)
    buf = _SLOT_ARRIVALS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024, 2 * (0 if buf is None else buf.numel())), dtype=torch.int32,
                          device=device)
        _SLOT_ARRIVALS[key] = buf
    return buf


def slot_reduce_backward(grad_out, perm, offsets):
    """The transpose of the segmented sum: grad_contrib[perm[e]] =
    grad_out[s] for e in [offsets[s], offsets[s+1]).  A gather over the plan
    and a permutation write: every row of grad_contrib is written once, so
    no atomics and the same bits on every run."""
    n_slots = offsets.shape[0] - 1
    seg = _segment_ids(offsets, n_slots, perm.shape[0])
    grad_contrib = grad_out.new_empty((perm.shape[0], grad_out.shape[1]))
    return grad_contrib.index_copy_(0, perm.long(), grad_out.index_select(0, seg))


class _SlotReduce(torch.autograd.Function):
    """``slot_reduce`` for autograd: the forward is the kernel (on the card)
    or the plain version (on the CPU), the backward
    ``slot_reduce_backward``."""

    @staticmethod
    def forward(ctx, contrib, perm, offsets, n_slots, longest):
        ctx.save_for_backward(perm, offsets)
        return _slot_reduce(contrib, perm, offsets, n_slots, longest)

    @staticmethod
    def backward(ctx, grad_out):
        perm, offsets = ctx.saved_tensors
        return slot_reduce_backward(grad_out.contiguous(), perm, offsets), None, None, None, None


def slot_reduce(contrib, perm, offsets, n_slots, longest=None):
    """out (n_slots, C), out[s] = sum_{e in [offsets[s], offsets[s+1])}
    contrib[perm[e]], for contrib (E, C) contiguous, perm (E,) int32 and
    offsets (n_slots + 1,) int32 ascending from 0 to E.  A slot without
    contributions (E = 0: all of them) is 0.

    ``longest``: the rows of the plan's longest segment (``SlotPlan.longest``
    or ``slot_longest``, noted where the plan is built), from which the
    kernel's body is chosen (``slot_reduce_body``); None takes the body that
    sums every plan.  The same plan and width with the same ``longest`` give
    the same bits on every call.

    Differentiable: where ``contrib`` requires grad and grad mode is on,
    the call goes through ``_SlotReduce``, whose backward is the gather of
    ``slot_reduce_backward``; elsewhere it is the kernel (or, on the CPU,
    the plain version) alone."""
    if contrib.requires_grad and torch.is_grad_enabled():
        return _SlotReduce.apply(contrib, perm, offsets, n_slots, longest)
    return _slot_reduce(contrib, perm, offsets, n_slots, longest)


def _slot_reduce(contrib, perm, offsets, n_slots, longest=None):
    if contrib.dim() != 2:
        raise ValueError(f"contrib: shape {tuple(contrib.shape)}, expected (E, C)")
    E, C = contrib.shape
    if contrib.dtype not in _SUFFIX:
        raise TypeError(f"contrib: dtype {contrib.dtype}, expected float32 or float64")
    _check("contrib", contrib, contrib.dtype, (E, C))
    _check("perm", perm, torch.int32, (E,))
    _check("offsets", offsets, torch.int32, (n_slots + 1,))
    if _route(contrib, perm, offsets) == "cpu":
        return slot_reduce_plain(contrib, perm, offsets, n_slots)
    out = torch.empty((n_slots, C), dtype=contrib.dtype, device=contrib.device)
    if n_slots * C == 0:  # nothing to write, and an empty grid is a launch error: no launch, no count
        return out
    from .._ext import library

    body = slot_reduce_body(E, n_slots, C, longest)
    tiles = slot_reduce_tiles(E) if body == "tiles" else 0
    unit, lanes, per_lane, group = slot_reduce_layout(E, C, contrib.element_size(), contrib.data_ptr())
    partial = torch.empty((2 * tiles, C), dtype=contrib.dtype, device=contrib.device)
    stream = torch.cuda.current_stream(contrib.device)
    arrivals = _slot_arrivals(contrib.device, stream, tiles)
    fn_name = f"pyslam_slot_reduce_{_SUFFIX[contrib.dtype]}"
    err = getattr(library(), fn_name)(
        contrib.data_ptr(), perm.data_ptr(), offsets.data_ptr(), out.data_ptr(), partial.data_ptr(),
        arrivals.data_ptr(), E, n_slots, C, _BODY[body], unit, lanes, per_lane, group, stream.cuda_stream,
    )
    _raise_on_error(fn_name, err)
    LAUNCHES["slot_reduce"] += 1
    LAUNCHES[f"slot_reduce.{body}"] += 1
    return out


# --------------------------------------------------------------------------
# Fused SE(3) linearize-and-assemble
# --------------------------------------------------------------------------

MAX_ASSEMBLE_BATCHES = 8  # the kernel's batch table
_LIN = 84  # values stage 1 stores a factor: J_0 (36), J_1 (36), w (6), w r (6)
_LINEARIZE_FACTORS = 32  # stage 1's block: one chi2 partial a block

_ASSEMBLE_ERRORS = {
    -1: f"more than {MAX_ASSEMBLE_BATCHES} factor batches",
    -2: "the scratch buffer is too small",
}


class AssembleBatch(NamedTuple):
    """One factor batch as ``ell_assemble`` takes it."""

    n_slots: int  # 2: between_se3 (poses T1, T2), 1: prior_se3
    T_obs: torch.Tensor  # (F, 4, 4)
    sqrt_info: torch.Tensor  # (F, 6, 6)
    weight: torch.Tensor  # (F,)
    loss: object


def kernel_loss(loss):
    """(id, c0, c1, c2) of a loss the ``ell_assemble`` kernel evaluates, the
    constants as ``losses.py`` forms them in Python floats; None for any
    other loss (``TDistributionLoss(scale=None)`` re-estimates its scale
    from all residuals, which is not elementwise)."""
    kind = type(loss)
    if kind is _losses.L2Loss:
        return 0, 0.0, 0.0, 0.0
    if kind is _losses.L1Loss:
        return 1, 0.0, 0.0, 0.0
    if kind is _losses.CauchyLoss:
        return 2, float(loss.k), 0.5 * loss.k**2, 0.0
    if kind is _losses.HuberLoss:
        return 3, float(loss.k), 0.0, 0.0
    if kind is _losses.TukeyLoss:
        return 4, float(loss.k), loss.k**2 / 6.0, 0.0
    if kind is _losses.TDistributionLoss and loss.scale is not None:
        return 5, float(loss.nu), loss.scale * loss.scale, 0.5 * (loss.nu + 1.0)
    return None


def ell_assemble_plain(poses, const_mask, batches, cols, idx, entries, rows, first):
    """Plain version, in the kernel's two stages on the kernel's own tables.
    Stage 1, per factor: both Jacobians, w and w r from ``lie/se3.py`` (a
    prior's one Jacobian first).  Stage 2: each factor's blocks D_a = J_a^T
    diag(w) J_a, C = J_0^T diag(w) J_1 and gradient rows J_a^T w r; then per
    entry of pose row r (``rows`` its segments of ``entries``) the entry's
    block (D_a, or C or its transpose for a factor on one pose twice) summed
    into r's diagonal slot; where the entry names an off-diagonal slot k, C
    (transposed where a = 1) summed into slot k; where a == b, its gradient
    row summed into pose r; each in table order."""
    LAUNCHES["ell_assemble_plain"] += 1
    nb, K = cols.shape
    n_factors = idx.shape[0]
    Jac = poses.new_zeros((n_factors, 2, 6, 6))
    w = poses.new_zeros((n_factors, 6))
    wr = poses.new_zeros((n_factors, 6))
    chi2 = poses.new_zeros(())
    for b, bt in enumerate(batches):
        lo, hi = first[b], first[b + 1]
        T_est = poses[idx[lo:hi, 1].long()]
        if bt.n_slots == 2:
            T_est = T_est @ se3.inv(poses[idx[lo:hi, 0].long()])
        r_local = se3.log(T_est @ se3.inv(bt.T_obs))
        r = (bt.sqrt_info @ r_local[..., None])[..., 0]
        J2 = bt.sqrt_info @ se3.inv_left_jacobian(r_local)
        if bt.n_slots == 2:
            Jac[lo:hi, 0] = -(J2 @ se3.adjoint(T_est))
            Jac[lo:hi, 1] = J2
        else:
            Jac[lo:hi, 0] = J2
        w[lo:hi] = bt.loss.weight(r) * bt.weight[:, None]
        wr[lo:hi] = w[lo:hi] * r
        chi2 = chi2 + torch.sum(bt.loss.loss(r) * bt.weight[:, None])
    D = Jac.transpose(-1, -2) @ (w[:, None, :, None] * Jac)  # (F, 2, 6, 6)
    C = Jac[:, 0].transpose(1, 2) @ (w[..., None] * Jac[:, 1])  # (F, 6, 6)
    G = (Jac.transpose(-1, -2) @ wr[:, None, :, None])[..., 0]  # (F, 2, 6)

    p, k = entries[:, 0].long(), entries[:, 1].long()
    f, a, b, t = p >> 3, (p >> 2) & 1, (p >> 1) & 1, (p & 1).bool()  # factor << 3 | a << 2 | b << 1 | t
    row = _segment_ids(rows, nb, entries.shape[0])
    own = a == b
    Cf = C[f]
    block = torch.where(own[:, None, None], D[f, a], torch.where(t[:, None, None], Cf.transpose(1, 2), Cf))
    He = poses.new_zeros((nb * K, 36)).index_add_(0, row * K, block.reshape(-1, 36))
    off = k > 0
    pair = torch.where(a[off].bool()[:, None, None], Cf[off].transpose(1, 2), Cf[off])
    He = He.index_add_(0, row[off] * K + k[off], pair.reshape(-1, 36)).reshape(nb, K, 6, 6)
    g = poses.new_zeros((nb, 6)).index_add_(0, row[own], G[f[own], a[own]])

    free = (~const_mask).to(poses.dtype)
    He = He * free[:, None, None, None] * free[cols.long()][:, :, None, None]
    He[:, 0] += (1.0 - free)[:, None, None] * torch.eye(6, dtype=poses.dtype, device=poses.device)
    return He, (-g * free[:, None]).reshape(-1), chi2


def ell_assemble(poses, const_mask, batches, cols, idx, entries, rows, first):
    """The direct-to-ELL normal equations of an SE(3) pose graph: (He (nb,
    K, 6, 6), g (nb*6,), chi2 0-dim), what ``bcsr.assemble_ell`` returns,
    as new tensors on every call.

    poses (nb, 4, 4) f32 or f64, const_mask (nb,) bool, ``batches`` a
    sequence of at most ``MAX_ASSEMBLE_BATCHES`` ``AssembleBatch``es whose
    losses ``kernel_loss`` takes, and the tables of ``bcsr.ell_device_plan``
    (``bcsr.build_assemble_tables``): cols (nb, K) int32, idx (F_total, 2)
    int32 the two poses of every factor (a prior names its pose twice),
    entries (E, 2) int32 by pose row the packed (factor, role) contributions
    to its diagonal slot beside the off-diagonal slot each names, rows (nb +
    1,) int32 their segments, ``first`` the host tuple of each batch's first
    factor and F_total.  Index values are trusted: the plan validates
    them."""
    if poses.dim() != 3 or tuple(poses.shape[1:]) != (4, 4):
        raise ValueError(f"poses: shape {tuple(poses.shape)}, expected (nb, 4, 4)")
    if poses.dtype not in _SUFFIX:
        raise TypeError(f"poses: dtype {poses.dtype}, expected float32 or float64")
    if cols.dim() != 2:
        raise ValueError(f"cols: shape {tuple(cols.shape)}, expected (nb, K)")
    nb, K = cols.shape
    dtype = poses.dtype
    first = tuple(int(v) for v in first)
    if len(first) != len(batches) + 1 or first[0] != 0 or any(b < a for a, b in zip(first, first[1:])):
        raise ValueError(f"first: {first}, expected {len(batches) + 1} ascending offsets from 0")
    if len(batches) > MAX_ASSEMBLE_BATCHES:
        raise ValueError(f"{len(batches)} factor batches, the kernel takes {MAX_ASSEMBLE_BATCHES}")
    n_factors = first[-1]
    _check("poses", poses, dtype, (nb, 4, 4))
    _check("const_mask", const_mask, torch.bool, (nb,))
    _check("cols", cols, torch.int32, (nb, K))
    _check("idx", idx, torch.int32, (n_factors, 2))
    if entries.dim() != 2 or entries.shape[1] != 2:
        raise ValueError(f"entries: shape {tuple(entries.shape)}, expected (E, 2)")
    _check("entries", entries, torch.int32, (entries.shape[0], 2))
    _check("rows", rows, torch.int32, (nb + 1,))
    codes = []
    for b, bt in enumerate(batches):
        F = first[b + 1] - first[b]
        if bt.n_slots not in (1, 2):
            raise ValueError(f"batch {b}: {bt.n_slots} slots, expected 1 (prior_se3) or 2 (between_se3)")
        _check(f"batch {b} T_obs", bt.T_obs, dtype, (F, 4, 4))
        _check(f"batch {b} sqrt_info", bt.sqrt_info, dtype, (F, 6, 6))
        _check(f"batch {b} weight", bt.weight, dtype, (F,))
        code = kernel_loss(bt.loss)
        if code is None:
            raise ValueError(f"batch {b}: the kernel does not evaluate {bt.loss!r}")
        codes.append(code)
    tensors = [poses, const_mask, cols, idx, entries, rows]
    for bt in batches:
        tensors += [bt.T_obs, bt.sqrt_info, bt.weight]
    for name, t in [("poses", poses)] + [(f"batch {b} {k}", getattr(bt, k)) for b, bt in enumerate(batches)
                                         for k in ("T_obs", "sqrt_info")]:
        if t.data_ptr() % 16:  # the kernel reads them 16 bytes at a time
            raise ValueError(f"{name}: storage not aligned to 16 bytes")
    for name, t in (("idx", idx), ("entries", entries)):
        if t.data_ptr() % 8:  # read as int2
            raise ValueError(f"{name}: storage not aligned to 8 bytes")
    if _route(*tensors) == "cpu":
        return ell_assemble_plain(poses, const_mask, batches, cols, idx, entries, rows, first)
    from .._ext import library

    dev = poses.device
    n = len(batches)

    def table(ctype, values):
        return (ctype * max(n, 1))(*values)

    t_obs = table(ctypes.c_void_p, [bt.T_obs.data_ptr() for bt in batches])
    sqrt_info = table(ctypes.c_void_p, [bt.sqrt_info.data_ptr() for bt in batches])
    weight = table(ctypes.c_void_p, [bt.weight.data_ptr() for bt in batches])
    first_c = (ctypes.c_int * (n + 1))(*first)
    n_slots = table(ctypes.c_int, [bt.n_slots for bt in batches])
    loss_id = table(ctypes.c_int, [c[0] for c in codes])
    loss_params = (ctypes.c_double * (3 * max(n, 1)))(*[v for c in codes for v in c[1:]])
    with torch.cuda.device(dev):
        He = torch.empty((nb, K, 6, 6), dtype=dtype, device=dev)
        g = torch.empty(nb * 6, dtype=dtype, device=dev)
        chi2 = torch.empty((), dtype=dtype, device=dev)
        # stage 1's per-factor values and its blocks' chi2 partials
        scratch_len = n_factors * _LIN + -(-n_factors // _LINEARIZE_FACTORS)
        scratch = torch.empty(scratch_len, dtype=dtype, device=dev)
        fn_name = f"pyslam_ell_assemble_{_SUFFIX[dtype]}"
        err = getattr(library(), fn_name)(
            poses.data_ptr(), const_mask.data_ptr(), cols.data_ptr(), idx.data_ptr(), entries.data_ptr(),
            rows.data_ptr(), n, *(ctypes.addressof(t) for t in (t_obs, sqrt_info, weight, first_c, n_slots,
                                                                   loss_id, loss_params)),
            scratch.data_ptr(), scratch_len, He.data_ptr(), g.data_ptr(), chi2.data_ptr(), nb, K,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err < 0:
        raise RuntimeError(f"{fn_name}: {_ASSEMBLE_ERRORS.get(err, err)}")
    _raise_on_error(fn_name, err)
    LAUNCHES["ell_assemble"] += 1
    return He, g, chi2


# --------------------------------------------------------------------------
# BAL reprojection rows of the Schur path
# --------------------------------------------------------------------------


def rows_of(dp: int) -> np.ndarray:
    """One observation's rows in the order they are stored, for a camera of
    ``dp`` dof and a 3-dof landmark: the camera gradient (dp) and upper
    Hessian (dp (dp + 1) / 2), the landmark gradient (3) and upper Hessian
    (6), W (3 dp); as positions in [g (n) | H (n²)] of the joint n = dp + 3
    column Jacobian [J_camera | J_landmark].  54 rows for an ``se3`` camera,
    90 for a ``bal_cam9`` one."""
    n = dp + 3
    return np.array(
        list(range(dp))
        + [n + n * i + j for i in range(dp) for j in range(i, dp)]
        + list(range(dp, n))
        + [n + n * i + j for i in range(dp, n) for j in range(i, n)]
        + [n + n * i + j for i in range(dp) for j in range(dp, n)]
    )


def _bal_camera(poses, f, k1, k2):
    """The camera dof of ``bal_rows``' arguments: 6 for se3 poses (C, 4, 4)
    with each observation's f, k1, k2; 9 for bal_cam9 cameras (C, 19), whose
    table carries them (f, k1, k2 None)."""
    intrinsics = [t is not None for t in (f, k1, k2)]
    if poses.dim() == 3 and tuple(poses.shape[1:]) == (4, 4) and all(intrinsics):
        return 6
    if poses.dim() == 2 and poses.shape[1] == 19 and not any(intrinsics):
        return 9
    raise ValueError(f"poses: shape {tuple(poses.shape)}, expected (C, 4, 4) with f, k1, k2 an observation, or "
                     "(C, 19) bal_cam9 cameras with f, k1, k2 None")


def _bal_data(obs, f, k1, k2, sqrt_info, dp):
    """(kind, data, per_obs) of the factor kernel the rows of a ``dp``-dof
    camera linearize."""
    data, per_obs = {"obs": obs, "sqrt_info": sqrt_info}, {"obs"}
    if dp == 6:
        data.update(f=f, k1=k1, k2=k2)
        per_obs |= {"f", "k1", "k2"}
    if sqrt_info.dim() == 3:
        per_obs.add("sqrt_info")
    return ("reprojection_bal" if dp == 6 else "reprojection_bal9"), data, per_obs


def bal_rows_plain(poses, lms, cam_idx, pt_idx, obs, f, k1, k2, sqrt_info, weight, loss, rows=True, chunk=None):
    """Plain version: ``schur_large.obs_chunks``, the ``reprojection_bal``
    (se3 poses) or ``reprojection_bal9`` (bal_cam9 cameras) factor kernel,
    the loss and ``schur._tmv`` / ``schur._jtwj``, over ``chunk``
    observations at a time (None: all at once)."""
    from .schur_large import obs_chunks  # schur_large imports this module

    LAUNCHES["bal_rows_plain"] += 1
    dp = _bal_camera(poses, f, k1, k2)
    kind, data, per_obs = _bal_data(obs, f, k1, k2, sqrt_info, dp)
    gather = torch.as_tensor(rows_of(dp), device=poses.device) if rows else None
    M = cam_idx.shape[0]
    return obs_chunks(kind, True, data, per_obs, poses, lms, cam_idx, pt_idx, weight, loss, gather, chunk or M)


def bal_rows_scale(poses, lms, cam_idx, pt_idx, obs, f, k1, k2, sqrt_info, weight, loss, chunk=None):
    """The scale of a difference from ``bal_rows_plain``, in f64: each row
    column's largest sum of the magnitudes of its terms (the rows of |J|,
    |w| and |r|), (54,) or (90,), and the largest cost, (1,).  An entry
    that cancels, such as the camera's H[2, 5], which sums terms of 1e6 to
    1e-11, keeps the rounding of its terms."""
    from ..graph.core import FACTOR_KERNELS
    from .schur import _jtwj, _tmv

    dp = _bal_camera(poses, f, k1, k2)
    poses, lms, obs, sqrt_info, weight = (t.double() for t in (poses, lms, obs, sqrt_info, weight))
    f, k1, k2 = (None if t is None else t.double() for t in (f, k1, k2))
    gather = rows_of(dp)
    kind, data, per_obs = _bal_data(obs, f, k1, k2, sqrt_info, dp)
    M = cam_idx.shape[0]
    rows, cost = poses.new_zeros(len(gather)), poses.new_zeros(1)
    for lo in range(0, M, chunk or max(M, 1)):
        hi = min(lo + (chunk or M), M)
        part_data = {k: (v[lo:hi] if k in per_obs else v) for k, v in data.items()}
        r, jacs = FACTOR_KERNELS[kind](part_data, poses[cam_idx[lo:hi]], lms[pt_idx[lo:hi]])
        J = torch.cat(jacs, -1).abs()
        w = (loss.weight(r) * weight[lo:hi, None]).abs()
        part = torch.cat([_tmv(J, w * r.abs()), _jtwj(J, w, J).flatten(1)], 1)[:, gather]
        rows = torch.maximum(rows, part.amax(0))
        cost = torch.maximum(cost, (loss.loss(r) * weight[lo:hi, None]).sum(1).amax(0, keepdim=True))
    return rows, cost


def bal_rows(poses, lms, cam_idx, pt_idx, obs, f, k1, k2, sqrt_info, weight, loss, rows=True, chunk=None):
    """Each monocular BAL observation's cost (M,) and, with ``rows``, its
    rows (M, 54) or (M, 90) in ``rows_of(dp)`` order (else
    None): with r the residual, J = [J_camera | J_landmark] and w =
    ``loss.weight(r) * weight``, the cost is sum(``loss.loss(r)`` *
    weight), the rows J^T w r and the upper triangle of J^T diag(w) J.

    Two cameras: se3 poses (C, 4, 4) with f, k1, k2 (M,) each
    observation's (``reprojection_bal``, 6 camera dof, 54 rows), or
    bal_cam9 cameras (C, 19) = [vec(T), f, k1, k2] with f, k1, k2 None
    (``reprojection_bal9``, 9 camera dof, the intrinsics estimated, 90
    rows).  poses f32 or f64, lms (L, 3), cam_idx and pt_idx (M,) int64
    (trusted: the plan validates them), obs and weight (M, 2) and (M,),
    sqrt_info (2, 2) for all observations or (M, 2, 2), all contiguous on
    one device, and a loss that ``kernel_loss`` takes.  On a CUDA device
    one launch (none for M = 0), counted in ``LAUNCHES["bal_rows"]`` or
    ``LAUNCHES["bal_rows9"]``, the same bits on every call; ``chunk`` is
    for the plain version, as the kernel holds no Jacobians."""
    dp = _bal_camera(poses, f, k1, k2)
    dtype = poses.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"poses: dtype {dtype}, expected float32 or float64")
    M = cam_idx.shape[0] if cam_idx.dim() == 1 else -1
    _check("poses", poses, dtype, tuple(poses.shape))
    _check("lms", lms, dtype, (lms.shape[0], 3))
    _check("cam_idx", cam_idx, torch.int64, (M,))
    _check("pt_idx", pt_idx, torch.int64, (M,))
    _check("obs", obs, dtype, (M, 2))
    for name, t in (("f", f), ("k1", k1), ("k2", k2), ("weight", weight)):
        if t is not None:
            _check(name, t, dtype, (M,))
    per_obs = sqrt_info.dim() == 3
    _check("sqrt_info", sqrt_info, dtype, (M, 2, 2) if per_obs else (2, 2))
    code = kernel_loss(loss)
    if code is None:
        raise ValueError(f"the kernel does not evaluate {loss!r}")
    tensors = (poses, lms, cam_idx, pt_idx, obs, f, k1, k2, sqrt_info, weight)
    if _route(*(t for t in tensors if t is not None)) == "cpu":
        return bal_rows_plain(*tensors, loss, rows, chunk)
    from .._ext import library

    dev = poses.device
    with torch.cuda.device(dev):
        cost = torch.empty(M, dtype=dtype, device=dev)
        out = torch.empty((M, len(rows_of(dp))), dtype=dtype, device=dev) if rows else None
        if M == 0:  # an empty grid is a launch error: no launch, no count
            return cost, out
        name = "bal_rows" if dp == 6 else "bal_rows9"
        fn_name = f"pyslam_{name}_{_SUFFIX[dtype]}"
        err = getattr(library(), fn_name)(
            *(0 if t is None else t.data_ptr() for t in tensors[:9]), int(per_obs), weight.data_ptr(), code[0],
            *code[1:], M, cost.data_ptr(), 0 if out is None else out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(fn_name, err)
    LAUNCHES[name] += 1
    return cost, out
