"""Hand-written CUDA kernels for the block-sparse hot ops, with their plain
PyTorch versions and launch counters.

Counterpart of ``pyslam_tpu/solver/pallas_ops.py``:

* ``ell_matvec`` (``csrc/ell_matvec.cu``) replaces ``ell_matvec_lane_major``
  / ``ell_matvec_pallas``: the symmetric-ELL block SpMV of every PCG
  iteration, y[r] = sum_k He[r, k] @ x[cols[r, k]].
* ``slot_reduce`` (``csrc/slot_reduce.cu``) replaces ``scatter_matmul``: the
  reduction of per-factor contributions into their ELL slots (and of the
  gradient rows into their poses) during assembly, as a deterministic
  segmented sum over a plan sorted by destination.

Dispatch: a tensor on the CPU goes to the plain version (the CPU tests use
it); a tensor on a CUDA device launches the kernel or raises.  There is no
fallback from the kernel to the plain version.  ``LAUNCHES`` counts, for
each function, the calls that ran it.  The source note of each kernel says
what bounds it on an H100 and what its design does about that.
"""

from __future__ import annotations

import torch

LAUNCHES = {"ell_matvec": 0, "ell_matvec_plain": 0, "slot_reduce": 0, "slot_reduce_plain": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
# Segmented slot reduction
# --------------------------------------------------------------------------


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
