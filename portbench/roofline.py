"""The yardstick of the kernels: published peaks of one NVIDIA H100 and
the operations and bytes each hand-written kernel's call needs.

A call's bound is the larger of its bytes over the memory rate and its
operations over the float32 rate outside the tensor cores (every kernel
here computes in float32 or float64 on the CUDA cores).  Each input byte
counts once and each output byte once, whatever the kernel reads again;
work that depends on the data (CG iterations) counts what was run.  The
arithmetic is the benchmark's own copy of ``chip_smoke.py``'s
``bound_ms`` and of its per-kernel counts, so that a later kernel that
does the same work is held to the same bound.

Each ``*_count`` takes a call's (args, kwargs, result), reads shapes only
(never the device) and returns a record for ``probes.Call``."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (700 W): HBM3 rate, float32 rate outside the
# tensor cores; float64 outside the tensor cores is half the latter.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "float64": 34e12}

# ell_assemble's operations, from its source (chip_smoke.py's
# ASSEMBLE_FLOP): a factor's linearization, a block J_a^T W J_b, a
# gradient row
ASSEMBLE_FLOP = {"factor": 1700, "contribution": 648, "gradient_row": 72}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_s(n_bytes, flop, dtype_name="float32") -> float:
    """The least time in seconds the card could take."""
    return max(n_bytes / PEAK_BYTES_PER_S, flop / PEAK_FLOP_PER_S[dtype_name])


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def slot_reduce_count(args, kwargs, out):
    """``cuda_ops._slot_reduce(contrib, perm, offsets, n_slots, longest)``:
    every row of contrib read once, one add a value, the sums written."""
    contrib, perm, offsets, n_slots = args[:4]
    if n_slots * contrib.shape[1] == 0:  # no launch
        return None
    return dict(bytes=nbytes(contrib, perm, offsets, out), flop=contrib.numel(), dtype=_dtype_name(contrib))


def ell_pcg_count(args, kwargs, out):
    """``ell_pcg(He, cols, Minv, b, rtol, max_iters)``: the operator, the
    preconditioner and b read once, x written once; an iteration is the ELL
    product and the block-Jacobi product (2 operations a stored value),
    three dot products and three vector updates (12 a row), for each
    column's iterations.  The iterations are the result's device tensor,
    read after the window."""
    He, cols, Minv, b = args[:4]
    nb, K, d, _ = He.shape
    return dict(bytes=nbytes(He, cols, Minv, b, out.x), flop_per_iteration=2 * nb * (K + 1) * d * d + 12 * nb * d,
                iterations=out.iterations, dtype=_dtype_name(He))


def ell_assemble_count(args, kwargs, out):
    """``ell_assemble(poses, const_mask, batches, cols, idx, entries, rows,
    first)``: the poses, measurements and tables read once, He, g and chi2
    written once; the operations of every factor, block and gradient row.
    A block is one for each entry of its row's diagonal, and one more for
    each entry that names an off-diagonal slot (the result's ``entries``
    column 1, counted after the window)."""
    poses, const_mask, batches, cols, idx, entries, rows, _ = args[:8]
    measurements = [t for bt in batches for t in (bt.T_obs, bt.sqrt_info, bt.weight)]
    n_rows = sum(bt.n_slots * bt.weight.shape[0] for bt in batches)
    return dict(bytes=nbytes(poses, const_mask, *measurements, cols, idx, entries, rows, *out),
                flop_fixed=ASSEMBLE_FLOP["factor"] * idx.shape[0] + ASSEMBLE_FLOP["gradient_row"] * n_rows,
                entries=entries, dtype=_dtype_name(poses))


def ell_pcg_bound(record) -> float:
    it = int(record["iterations"].sum())
    return bound_s(record["bytes"], record["flop_per_iteration"] * it, record["dtype"])


def ell_assemble_bound(record) -> float:
    entries = record["entries"]
    n_blocks = entries.shape[0] + int((entries[:, 1] > 0).sum())
    return bound_s(record["bytes"], record["flop_fixed"] + ASSEMBLE_FLOP["contribution"] * n_blocks, record["dtype"])


def slot_reduce_bound(record) -> float:
    return bound_s(record["bytes"], record["flop"], record["dtype"])
