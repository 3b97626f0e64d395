"""GN/LM solver core on torch tensors.  Ported so far: the ``solve_ell``
pose-graph path (direct-to-ELL assembly, block-Jacobi PCG, LM) and its two
CUDA kernels."""

from .assemble import free_mask, linearize_batch
from .bcsr import (
    EllDevicePlan,
    EllDirect,
    SlotPlan,
    assemble_ell,
    build_ell_direct,
    build_slot_plans,
    ell_contributions,
    ell_device_plan,
    solve_ell,
    sym_block_inv,
)
from .cuda_ops import LAUNCHES, ell_matvec, ell_matvec_plain, slot_reduce, slot_reduce_plain
from .linear import HOST_READS, pcg_solve
from .lm import STATUS_NAMES, Options, SolveInfo, solve

__all__ = [
    "Options",
    "SolveInfo",
    "STATUS_NAMES",
    "solve",
    "linearize_batch",
    "free_mask",
    "pcg_solve",
    "HOST_READS",
    "EllDirect",
    "EllDevicePlan",
    "SlotPlan",
    "build_ell_direct",
    "build_slot_plans",
    "ell_contributions",
    "ell_device_plan",
    "assemble_ell",
    "sym_block_inv",
    "solve_ell",
    "LAUNCHES",
    "ell_matvec",
    "ell_matvec_plain",
    "slot_reduce",
    "slot_reduce_plain",
]
