"""Hand-written CUDA kernels for the block-sparse hot ops, with their plain
PyTorch versions and launch counters.

Counterpart of ``pyslam_tpu/solver/pallas_ops.py``:

* ``ell_matvec`` (``csrc/ell_matvec.cu``) replaces ``ell_matvec_lane_major``
  / ``ell_matvec_pallas``: the symmetric-ELL block SpMV, y[r] = sum_k
  He[r, k] @ x[cols[r, k]] (dogleg's model products on ``solve_ell``).
* ``ell_pcg`` (``csrc/ell_pcg.cu``) is that product at the grain this card
  wants it: the whole block-Jacobi PCG solve of ``solve_ell`` (the
  reference's ``_pcg`` ``while_loop`` around ``ell_matvec_lane_major``) as
  one persistent launch, with He resident in shared memory.
* ``slot_reduce`` (``csrc/slot_reduce.cu``) replaces ``scatter_matmul``: the
  reduction of per-factor contributions into their ELL slots (and of the
  gradient rows into their poses) during assembly, as a deterministic
  segmented sum over a plan sorted by destination.

Dispatch: a tensor on the CPU goes to the plain version (the CPU tests use
it); a tensor on a CUDA device launches the kernel or raises.  There is no
fallback from the kernel to the plain version.  ``LAUNCHES`` counts, for
each function, the calls that ran it; ``pcg_iterations`` reads the CG
iterations that ``ell_pcg`` launches summed on the device.  The source note
of each kernel says what bounds it on an H100 and what its design does
about that.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import linear

LAUNCHES = {
    "ell_matvec": 0, "ell_matvec_plain": 0,
    "ell_pcg": 0, "ell_pcg_plain": 0,
    "slot_reduce": 0, "slot_reduce_plain": 0,
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
    nb, K, d, _ = He.shape
    xg = x.reshape(nb, d)[cols]  # (nb, K, d)
    return torch.einsum("rkij,rkj->ri", He, xg).reshape(-1)


def ell_matvec(He, cols, x):
    """y (nb*d,) = sum_k He[r, k] @ x[cols[r, k]] for He (nb, K, d, d)
    contiguous, cols (nb, K) int32 with entries in [0, nb), x (nb*d,)."""
    if He.dim() != 4 or He.shape[2] != He.shape[3]:
        raise ValueError(f"He: shape {tuple(He.shape)}, expected (nb, K, d, d)")
    nb, K, d, _ = He.shape
    if He.dtype not in _SUFFIX:
        raise TypeError(f"He: dtype {He.dtype}, expected float32 or float64")
    _check("He", He, He.dtype, (nb, K, d, d))
    _check("cols", cols, torch.int32, (nb, K))
    _check("x", x, He.dtype, (nb * d,))
    if _route(He, cols, x) == "cpu":
        return ell_matvec_plain(He, cols, x)
    from .._ext import library

    y = torch.empty_like(x)
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
    x: torch.Tensor  # (nb*d,)
    iterations: torch.Tensor  # 0-dim int32, on x's device
    # Block rows (of nb) whose He, cols and Minv the kernel kept in shared
    # memory for the whole solve; the others were read from device memory
    # every iteration.  None from the plain version.
    resident_rows: int | None


_PCG_ERRORS = {
    -1: "the device does not support cooperative launch",
    -2: "the solve's vectors do not fit in shared memory (nb * d too large for this kernel)",
    -3: "the grid cannot be co-resident with this much shared memory",
}
_PCG_PLANS: dict = {}


def ell_pcg_plan(nb, K, d, dtype, device) -> dict:
    """The launch geometry of ``ell_pcg`` for these shapes on ``device``, as
    the library computes it: ``grid`` (blocks, one per SM at most),
    ``rows_per_block``, ``resident_rows`` (of nb), ``smem_bytes`` (dynamic
    shared memory a block) and ``lanes`` (sub-warp width of a row
    product)."""
    from .._ext import library

    device = torch.device(device)
    key = (nb, K, d, dtype, device)
    if key not in _PCG_PLANS:
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(device):
            err = library().pyslam_ell_pcg_plan(nb, K, d, torch.finfo(dtype).bits // 8, out)
        _raise_on_pcg_error("pyslam_ell_pcg_plan", err)
        _PCG_PLANS[key] = dict(zip(("grid", "rows_per_block", "resident_rows", "smem_bytes", "lanes"), out))
    return _PCG_PLANS[key]


def _raise_on_pcg_error(fn_name, err):
    if err < 0:
        raise RuntimeError(f"{fn_name}: {_PCG_ERRORS.get(err, err)}")
    _raise_on_error(fn_name, err)


def ell_pcg_plain(He, cols, Minv, b, rtol, max_iters):
    """Plain version: ``linear.pcg_solve`` (the host loop, one stop test
    read back per iteration) over ``ell_matvec_plain`` and the batched
    ``Minv @ r``."""
    LAUNCHES["ell_pcg_plain"] += 1
    nb, _, d, _ = He.shape

    def precond(r):
        return (Minv @ r.reshape(nb, d, 1)).reshape(-1)

    x, it = linear.pcg_solve(
        lambda v: ell_matvec_plain(He, cols, v), b, precond=precond, rtol=rtol, max_iters=max_iters
    )
    return PcgResult(x, torch.tensor(it, dtype=torch.int32, device=b.device), None)


def ell_pcg(He, cols, Minv, b, rtol, max_iters):
    """Solve A x = b by block-Jacobi preconditioned CG from x0 = 0, where
    (A v)[r] = sum_k He[r, k] @ v[cols[r, k]] and the preconditioner is
    z[r] = Minv[r] @ r[r]: ``linear.pcg_solve``'s recurrences and stop rule
    (continue while ``norm(r) > rtol * norm(b)`` and ``it < max_iters``,
    tested before every iteration; a NaN ends the loop).

    He (nb, K, d, d), cols (nb, K) int32 with entries in [0, nb), Minv
    (nb, d, d), b (nb*d,), all contiguous on one device.  Returns a
    ``PcgResult``.  On a CUDA device the whole solve is one launch and makes
    no host read.  The kernel takes r0 = b without forming A @ x0; the two
    differ only where He holds a non-finite value (``pcg_solve`` then stops
    at once with x = 0, the kernel returns NaN after one iteration: LM
    rejects either step)."""
    if He.dim() != 4 or He.shape[2] != He.shape[3]:
        raise ValueError(f"He: shape {tuple(He.shape)}, expected (nb, K, d, d)")
    nb, K, d, _ = He.shape
    if He.dtype not in _SUFFIX:
        raise TypeError(f"He: dtype {He.dtype}, expected float32 or float64")
    _check("He", He, He.dtype, (nb, K, d, d))
    _check("cols", cols, torch.int32, (nb, K))
    _check("Minv", Minv, He.dtype, (nb, d, d))
    _check("b", b, He.dtype, (nb * d,))
    rtol, max_iters = float(rtol), int(max_iters)
    if max_iters < 0:
        raise ValueError(f"max_iters: {max_iters}, expected >= 0")
    if _route(He, cols, Minv, b) == "cpu":
        return ell_pcg_plain(He, cols, Minv, b, rtol, max_iters)
    from .._ext import library

    lib = library()
    dev = b.device
    plan = ell_pcg_plan(nb, K, d, He.dtype, dev)
    with torch.cuda.device(dev):
        if dev not in _PCG_ITERATIONS:
            _PCG_ITERATIONS[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
        x = torch.empty_like(b)
        iterations = torch.empty((), dtype=torch.int32, device=dev)
        # p of two iterations in turn, z, and the blocks' partial dot products
        scratch = torch.empty(3 * nb * d + 3 * plan["grid"], dtype=He.dtype, device=dev)
        fn_name = f"pyslam_ell_pcg_{_SUFFIX[He.dtype]}"
        err = getattr(lib, fn_name)(
            He.data_ptr(), cols.data_ptr(), Minv.data_ptr(), b.data_ptr(), x.data_ptr(),
            scratch.data_ptr(), iterations.data_ptr(), _PCG_ITERATIONS[dev].data_ptr(),
            nb, K, d, rtol, max_iters, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_pcg_error(fn_name, err)
    LAUNCHES["ell_pcg"] += 1
    return PcgResult(x, iterations, plan["resident_rows"])


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


def slot_plan(dest: np.ndarray, n_slots: int) -> SlotPlan:
    """The ``slot_reduce`` plan of contributions with destinations ``dest``
    (host, numpy); raises on a destination outside [0, n_slots)."""
    dest = np.asarray(dest, np.int64)
    if len(dest) and (dest.min() < 0 or dest.max() >= n_slots):
        raise ValueError(f"slot destination out of range [0, {n_slots})")
    if len(dest) >= 2**31:
        raise ValueError("too many contributions for int32 offsets")
    perm = np.argsort(dest, kind="stable").astype(np.int32)
    counts = np.bincount(dest, minlength=n_slots)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return SlotPlan(perm, offsets, n_slots)


def slot_reduce_plain(contrib, perm, offsets, n_slots):
    """Plain version: index_add_ of the permuted contributions into their
    segment ids."""
    LAUNCHES["slot_reduce_plain"] += 1
    counts = (offsets[1:] - offsets[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(n_slots, device=contrib.device), counts)
    out = torch.zeros((n_slots, contrib.shape[1]), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, seg, contrib[perm.long()])


def slot_reduce(contrib, perm, offsets, n_slots):
    """out (n_slots, C), out[s] = sum_{e in [offsets[s], offsets[s+1])}
    contrib[perm[e]], for contrib (E, C) contiguous, perm (E,) int32 and
    offsets (n_slots + 1,) int32 ascending from 0 to E."""
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
    from .._ext import library

    out = torch.empty((n_slots, C), dtype=contrib.dtype, device=contrib.device)
    fn_name = f"pyslam_slot_reduce_{_SUFFIX[contrib.dtype]}"
    err = getattr(library(), fn_name)(
        contrib.data_ptr(), perm.data_ptr(), offsets.data_ptr(), out.data_ptr(), n_slots, C,
        torch.cuda.current_stream(contrib.device).cuda_stream,
    )
    _raise_on_error(fn_name, err)
    LAUNCHES["slot_reduce"] += 1
    return out
