"""GN/LM solver core on torch tensors.  Ported so far: the dense path
(``assemble_dense``, Cholesky), 'lm' / 'gn' / 'dogleg', ``solve_one_iter``,
the ``solve_ell`` pose-graph path (direct-to-ELL assembly, block-Jacobi
PCG), the Schur-complement path of bundle adjustment and landmark SLAM
(``ba_assemble``, ``solve_schur`` in its 'dense' and 'pcg' modes) and the
four CUDA kernels (``ell_matvec``, ``ell_pcg``, ``slot_reduce``,
``ell_assemble``)."""

from .assemble import (
    DensePlan,
    assemble_dense,
    dense_contributions,
    dense_plan,
    free_mask,
    gradient_and_chi2,
    linearize_batch,
    unit_diag_where_dead,
)
from .bcsr import (
    EllDevicePlan,
    EllDirect,
    assemble_ell,
    build_ell_direct,
    build_slot_plans,
    ell_contributions,
    ell_device_plan,
    solve_ell,
    sym_block_inv,
)
from .cuda_ops import (
    LAUNCHES,
    PcgResult,
    SlotPlan,
    ell_matvec,
    ell_matvec_plain,
    ell_pcg,
    ell_pcg_plain,
    ell_pcg_plan,
    pcg_iterations,
    slot_plan,
    slot_reduce,
    slot_reduce_plain,
)
from .linear import HOST_READS, cholesky_solve, damp_marquardt, pcg_solve
from .lm import STATUS_NAMES, Options, SolveInfo, solve, solve_one_iter
from .schur import ba_assemble, solve_schur

__all__ = [
    "Options",
    "SolveInfo",
    "STATUS_NAMES",
    "solve",
    "solve_one_iter",
    "ba_assemble",
    "solve_schur",
    "assemble_dense",
    "gradient_and_chi2",
    "cholesky_solve",
    "damp_marquardt",
    "pcg_solve",
    "linearize_batch",
    "free_mask",
    "unit_diag_where_dead",
    "DensePlan",
    "dense_plan",
    "dense_contributions",
    "HOST_READS",
    "EllDirect",
    "EllDevicePlan",
    "SlotPlan",
    "slot_plan",
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
    "PcgResult",
    "ell_pcg",
    "ell_pcg_plain",
    "ell_pcg_plan",
    "pcg_iterations",
    "slot_reduce",
    "slot_reduce_plain",
]
