"""GN/LM solver core on torch tensors.  Ported so far: the dense path
(``assemble_dense``, Cholesky), 'lm' / 'gn' / 'dogleg', ``solve_one_iter``,
the ``solve_ell`` pose-graph path (direct-to-ELL assembly, block-Jacobi
or two-level PCG), the BCSR family (``build_pattern``, ``assemble_bcsr``,
``bcsr_matvec``, ``solve_bcsr``), the Schur-complement path of bundle adjustment and landmark SLAM
(``ba_assemble``, ``solve_schur`` in its 'dense' and 'pcg' modes), the
multifrontal sparse Cholesky (``solve_sparse_chol``) and SPARSE_SCHUR
(``solve_schur_sparse``), Venice-scale bundle adjustment
(``solve_schur_large`` on the shared host LM loop ``host_lm_loop``), the
structure dispatch (``route_auto``, ``solve_auto``; their mesh routes
run ``dist/``), the batched fleet solve (``solve_batched``), the
outlier-robust ``solve_gnc`` (graduated non-convexity), the online
smoothers (``FixedLagSmoother``, ``FixedLagLandmarkSmoother``,
``IncrementalSmoother``), posterior covariance (``covariance.py``),
differentiable solving (``solve_implicit``) and the four CUDA kernels
(``ell_matvec``, ``ell_pcg``, ``slot_reduce``, ``ell_assemble``)."""

import numpy as np

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
    BlockPattern,
    EllDevicePlan,
    EllDirect,
    assemble_bcsr,
    assemble_ell,
    bcsr_matvec,
    build_ell_direct,
    build_pattern,
    build_slot_plans,
    ell_contributions,
    ell_device_plan,
    solve_bcsr,
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
from .host_loop import host_lm_loop, host_lm_loop_speculative
from .linear import HOST_READS, LM_TRIALS, cholesky_solve, damp_marquardt, pcg_solve
from .lm import STATUS_NAMES, Options, SolveInfo, solve, solve_one_iter
from .batched import BatchedSolveInfo, solve_batched
from .gnc import GNCInfo, solve_gnc
from .schur import ba_assemble, solve_schur
from .schur_large import prepare_large_ba, solve_schur_large
from .schur_sparse import (
    SchurSparsePlan,
    assemble_S_ell,
    build_schur_sparse_plan,
    coobservation_stats,
    solve_schur_sparse,
)
from .schur_sqrt import SqrtBAPlan, build_sqrt_plan, solve_schur_sqrt
from .sparse_chol import (
    CholPlan,
    build_chol_plan,
    factor_logdet,
    locate_fill_pairs,
    selected_inverse_marginals,
    solve_sparse_chol,
    sparse_chol_solve,
)
from .covariance import (
    covariance_block,
    covariance_blocks_direct,
    full_covariance,
    landmark_covariance_block,
    landmark_marginal_covariances,
    marginal_covariances,
    marginal_covariances_direct,
    pose_covariance_block,
    pose_landmark_covariance_block,
    pose_marginal_covariances,
)
from .diff import solve_implicit
from .fixed_lag import FixedLagLandmarkSmoother, FixedLagSmoother
from .incremental import IncrementalSmoother

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
    "LM_TRIALS",
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
    "BlockPattern",
    "build_pattern",
    "assemble_bcsr",
    "bcsr_matvec",
    "solve_bcsr",
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
    "CholPlan",
    "build_chol_plan",
    "sparse_chol_solve",
    "solve_sparse_chol",
    "selected_inverse_marginals",
    "locate_fill_pairs",
    "factor_logdet",
    "full_covariance",
    "marginal_covariances",
    "marginal_covariances_direct",
    "covariance_block",
    "covariance_blocks_direct",
    "pose_marginal_covariances",
    "pose_covariance_block",
    "landmark_marginal_covariances",
    "landmark_covariance_block",
    "pose_landmark_covariance_block",
    "SchurSparsePlan",
    "assemble_S_ell",
    "build_schur_sparse_plan",
    "coobservation_stats",
    "solve_schur_sparse",
    "BatchedSolveInfo",
    "solve_batched",
    "route_auto",
    "solve_auto",
    "host_lm_loop",
    "host_lm_loop_speculative",
    "solve_schur_large",
    "prepare_large_ba",
    "solve_gnc",
    "GNCInfo",
    "SqrtBAPlan",
    "build_sqrt_plan",
    "solve_schur_sqrt",
    "FixedLagSmoother",
    "FixedLagLandmarkSmoother",
    "IncrementalSmoother",
    "solve_implicit",
]


def _mono_low_parallax(graph, pose_name, lm_name, max_obs=500_000, spread_thresh=1.4e-3):
    """True when a monocular BA graph's landmark geometry is low-parallax
    (the f32-ill-conditioned regime where the square-root path wins).

    Cheap host check at dispatch time: per-landmark resultant length of the
    unit observation rays — parallax std angle ~ sqrt(2 * (1 - |mean ray|)),
    threshold ~3 degrees.  Stereo/RGB-D (3-dof residuals) return False;
    conditioning never bites when observations carry depth.  Reads the
    camera and landmark values to the host."""
    binary = [fb for fb in graph.batches if tuple(fb.slots) in ((pose_name, lm_name), (lm_name, pose_name))]
    if len(binary) != 1 or binary[0].n > max_obs:
        return False
    fb = binary[0]
    data = getattr(fb, "data", None)
    obs = None if data is None else data.get("obs")
    if obs is None or obs.ndim != 2 or obs.shape[-1] != 2:
        return False  # not monocular
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    if pb.kind != "se3":
        return False
    ci, li = (_host(i).astype(np.int64) for i in (fb.indices if fb.slots[0] == pose_name else fb.indices[::-1]))
    T = _host(pb.values).astype(np.float64)  # (C, 4, 4) world -> cam
    R, t = T[:, :3, :3], T[:, :3, 3]
    centers = -np.einsum("cji,cj->ci", R, t)
    pts = _host(lb.values).astype(np.float64)
    rays = pts[li] - centers[ci]
    rays /= np.maximum(np.linalg.norm(rays, axis=1, keepdims=True), 1e-12)
    s = np.zeros((lb.n, 3))
    np.add.at(s, li, rays)
    cnt = np.bincount(li, minlength=lb.n)
    multi = cnt >= 2
    if not multi.any():
        return False
    spread = 1.0 - np.linalg.norm(s[multi], axis=1) / cnt[multi]
    return bool(np.median(spread) < spread_thresh)


def _host(t):
    """A tensor (or array) as a numpy array on the host."""
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _mesh_route(graph, is_ba, lie_blocks, euc_blocks, n_dev, dense_dof_limit, device_hbm_budget_bytes, tiny_dof,
                cm_obs_crossover):
    """The route on a mesh of ``n_dev`` > 1 ranks, as the reference decides
    it (``pyslam_tpu/solver/__init__.py:176-222``), with the sizes priced in
    the logical bytes of the port's tensors; the reference prices a block
    as one (8, 128) f32 tile of a TPU's memory (``_TILE_BYTES``)."""
    blocks = graph.blocks
    if is_ba:
        pose_name, lm_name = lie_blocks[0], euc_blocks[0]
        obs_slots = ((pose_name, lm_name), (lm_name, pose_name))
        n_obs = sum(fb.n for fb in graph.batches if tuple(fb.slots) in obs_slots)
        pb, lb = blocks[pose_name], blocks[lm_name]
        obs_per_dev = n_obs // n_dev
        # what a rank of schur_reduce holds for one observation: W, its
        # camera block and gradient row, its landmark block and gradient row
        dp, dl = pb.dof, lb.dof
        slab_bytes = obs_per_dev * (dp * dl + dp * dp + dp + dl * dl + dl) * pb.values.dtype.itemsize
        # the component-major layout is specialized to (6, 3)-dof blocks;
        # 9-dof bal_cam9 graphs stay on the dof-generic schur_reduce
        if dp == 6 and (slab_bytes > device_hbm_budget_bytes or obs_per_dev > cm_obs_crossover):
            return "schur_cm"
        return "schur_reduce"
    if len(blocks) == 1:
        if graph.total_dof <= tiny_dof:
            return "factor_parallel"
        blk = next(iter(blocks.values()))
        # the symmetric ELL store: nb rows of K blocks; K ~ 1 + twice the
        # mean degree (the largest degree is about twice the mean)
        n_edges = sum(fb.n for fb in graph.batches if len(set(fb.slots)) == 1 and len(fb.slots) == 2)
        K_est = 1 + int(np.ceil(2 * n_edges / max(blk.n, 1))) * 2
        ell_bytes = blk.n * K_est * blk.dof * blk.dof * blk.values.dtype.itemsize
        return "pose_sharded" if ell_bytes > device_hbm_budget_bytes else "ell"
    # other multi-block graphs: factor_parallel is block-structure-agnostic,
    # up to the dense-solve ceiling; beyond it no sharded path applies
    if graph.total_dof <= dense_dof_limit:
        return "factor_parallel"
    import warnings

    warnings.warn(
        "route_auto: no sharded path supports this multi-block graph "
        f"({len(blocks)} variable blocks, total_dof={graph.total_dof} > "
        f"dense_dof_limit={dense_dof_limit}); solving REPLICATED on a "
        "single device.  Supported mesh routes: 2-block BA "
        "(schur_reduce/schur_cm), single-block pose graphs "
        "(ell/pose_sharded), any-structure graphs up to "
        "dense_dof_limit (factor_parallel).",
        stacklevel=4,
    )
    return "_single"


def route_auto(
    graph,
    mesh=None,
    dense_dof_limit: int = 12000,
    dense_hpl_budget_bytes: int = 1 << 30,
    device_hbm_budget_bytes: int = 10 << 30,
    tiny_dof: int = 2000,
    schur_sparse_pair_budget: int = 2_000_000,
    cm_obs_crossover: int = 250_000,
):
    """Name of the solve path ``solve_auto`` picks for this graph (and
    mesh).

    Single-chip routes, decided as in the reference with its thresholds
    (dof counts and logical bytes): ``dense`` / ``sparse_chol`` / ``ell`` /
    ``schur_dense`` / ``schur_sparse`` (exact multifrontal factorization of
    the reduced camera system: many-poses / few-landmarks graphs with
    sparse co-observation) / ``schur_pcg`` / ``schur_sqrt`` (f32 mono
    low-parallax conditioning) / ``schur_large``.  A graph is bundle
    adjustment when it has one Lie and one euclidean block and a binary
    batch between them in EITHER slot order (the reference sees only
    (pose, landmark) and sends a (landmark, pose) graph to the dense path).

    Mesh routes (``mesh`` a ``dist.Mesh`` of more than one rank; a 1-rank
    mesh takes the single-chip routes): ``factor_parallel`` (single-block
    graphs of at most ``tiny_dof`` dof, and other multi-block graphs up to
    ``dense_dof_limit``), ``pose_sharded`` (single-block graphs whose ELL
    store exceeds ``device_hbm_budget_bytes``; below it ``ell``,
    replicated), ``schur_reduce`` (camera + landmark), ``schur_cm`` (6-dof
    camera + landmark graphs whose observations per rank exceed the budget
    or ``cm_obs_crossover``), and ``_single`` with a warning for a
    multi-block graph beyond the dense ceiling.  Sizes are logical bytes of
    the port's tensors, not the reference's TPU tiles, so the two part on
    some graphs (a pose graph of 1.5 M SE(3) poses and 6 M edges is
    ``ell`` here and ``pose_sharded`` there)."""
    blocks = graph.blocks
    kinds = {name: b.kind for name, b in blocks.items()}
    lie_blocks = [n for n, k in kinds.items() if k != "euclidean"]
    euc_blocks = [n for n, k in kinds.items() if k == "euclidean"]
    # BA shape = one lie + one euclidean block AND at least one binary batch
    # between them — a 2-block graph coupled only by other factor arities
    # (e.g. switchable pose graphs) is NOT BA and must not enter the Schur
    # routes
    is_ba = (
        len(blocks) == 2
        and len(lie_blocks) == 1
        and len(euc_blocks) == 1
        and any(
            tuple(fb.slots) in ((lie_blocks[0], euc_blocks[0]), (euc_blocks[0], lie_blocks[0]))
            for fb in graph.batches
        )
    )
    n_dev = 1 if mesh is None else mesh.size
    if n_dev > 1:
        return _mesh_route(graph, is_ba, lie_blocks, euc_blocks, n_dev, dense_dof_limit, device_hbm_budget_bytes,
                           tiny_dof, cm_obs_crossover)

    if is_ba:
        pose_name, lm_name = lie_blocks[0], euc_blocks[0]
        obs_slots = ((pose_name, lm_name), (lm_name, pose_name))
        binary = [fb for fb in graph.batches if tuple(fb.slots) in obs_slots]
        others = [fb for fb in graph.batches if tuple(fb.slots) not in obs_slots]
        n_obs = sum(fb.n for fb in binary)
        if (
            n_obs > 2_000_000
            and len(binary) == 1
            # schur_large takes se3 and 9-dof bal_cam9 cameras (the
            # reference's takes se3 only and sends bal_cam9 graphs to the
            # generic Schur PCG) with 3-dof landmarks
            and blocks[pose_name].kind in ("se3", "bal_cam9")
            and blocks[lm_name].dof == 3
            and all(
                fb.slots in ((pose_name,), (pose_name, pose_name)) for fb in others
            )
        ):
            return "schur_large"
        pb, lb = blocks[pose_name], blocks[lm_name]
        itemsize = pb.values.dtype.itemsize
        # Conditioning route: in f32, monocular low-parallax geometry
        # squares Jl's condition number through Hll = Jl^T Jl; the
        # square-root (QR) elimination tracks the f64 trajectory closer.
        # Stereo/RGB-D observations carry depth — mono 2-dof residuals only.
        if (
            pb.n * pb.dof <= 4096
            and itemsize == 4
            and len(binary) == 1
            and lb.dof == 3
            and all(fb.slots == (pose_name,) for fb in others)
            and _mono_low_parallax(graph, pose_name, lm_name)
        ):
            return "schur_sqrt"
        hpl_bytes = pb.n * pb.dof * lb.n * lb.dof * itemsize
        if pb.n * pb.dof <= 4096 and 2 * hpl_bytes <= dense_hpl_budget_bytes:
            return "schur_dense"
        # SPARSE_SCHUR: beyond the dense ceiling, when the co-observation
        # camera graph is sparse (many poses / few landmarks), the reduced S
        # factors EXACTLY through the multifrontal path at O(fill) instead
        # of trusting iterative Schur PCG.  Gate on the co-observation pair
        # count (sum of squared landmark degrees): first the shape-only
        # Cauchy-Schwarz lower bound n_obs^2 / L (no index arrays touched),
        # then the real count.
        pair_budget = min(schur_sparse_pair_budget, 96 * pb.n)
        if (
            n_obs > 0
            and n_obs * n_obs <= pair_budget * max(lb.n, 1)
            and all(
                tuple(fb.slots) in ((pose_name,), (pose_name, pose_name)) + obs_slots
                for fb in graph.batches
            )
        ):
            pairs_sq, _ = coobservation_stats(graph, pose_name, lm_name)
            if pairs_sq <= pair_budget:
                return "schur_sparse"
        return "schur_pcg"
    if len(blocks) == 1 and graph.total_dof > dense_dof_limit:
        blk = next(iter(blocks.values()))
        # Stiff 2D graphs need EXACT solves (PCG stalls in a worse basin) —
        # beyond the dense ceiling, the multifrontal sparse Cholesky is the
        # exact option.  2D dissection separators stay narrow, so the fill is
        # cheap there; 3D-ish SE(3) graphs keep the ELL PCG default.
        if blk.dof == 3 and blk.kind in ("se2", "euclidean"):
            return "sparse_chol"
        return "ell"
    return "dense"


def solve_auto(
    graph,
    options=None,
    mesh=None,
    dense_dof_limit: int = 12000,
    dense_hpl_budget_bytes: int = 1 << 30,
    device_hbm_budget_bytes: int = 10 << 30,
    schur_sparse_pair_budget: int = 2_000_000,
    cm_obs_crossover: int = 250_000,
):
    """Structure-dispatching solve: runs the path ``route_auto`` names.

    * camera + landmark blocks -> Schur complement: ``solve_schur`` in
      'dense' mode (few cameras) or 'pcg' mode, ``solve_schur_sparse``
      (many poses, sparse co-observation), ``solve_schur_sqrt`` (f32
      monocular low-parallax graphs: square-root elimination), or
      ``solve_schur_large`` (more than 2,000,000 observations of se3 or
      bal_cam9 cameras);
    * single variable block, total dof <= dense_dof_limit -> dense Cholesky;
      larger -> ``solve_sparse_chol`` (3-dof SE(2) / euclidean) or
      ``solve_ell`` (block-Jacobi PCG);
    * anything else -> the dense path.

    With ``mesh`` (a ``dist.Mesh`` of more than one rank; every rank calls
    this with the whole graph): ``dist.solve_factor_parallel``,
    ``dist.solve_pose_sharded`` or ``dist.solve_schur_sharded``, as
    ``route_auto`` decides; ``ell`` solves replicated on every rank, and
    ``_single`` (after its warning) the dense path.

    ``dist.solve_schur_cm`` past ``cm_obs_crossover`` observations a rank
    (route ``schur_cm``).  Returns (solved_graph, SolveInfo); on
    ``schur_large`` and the mesh routes, as in the reference,
    (solved_graph, cost_history)."""
    opts = options if options is not None else Options()
    route = route_auto(
        graph,
        mesh=mesh,
        dense_dof_limit=dense_dof_limit,
        dense_hpl_budget_bytes=dense_hpl_budget_bytes,
        device_hbm_budget_bytes=device_hbm_budget_bytes,
        schur_sparse_pair_budget=schur_sparse_pair_budget,
        cm_obs_crossover=cm_obs_crossover,
    )
    kinds = {name: b.kind for name, b in graph.blocks.items()}
    names = dict(
        pose_name=next((n for n, k in kinds.items() if k != "euclidean"), None),
        lm_name=next((n for n, k in kinds.items() if k == "euclidean"), None),
    )
    if route in ("factor_parallel", "pose_sharded", "schur_reduce", "schur_cm"):
        from .. import dist

        if route == "factor_parallel":
            solved, _, history = dist.solve_factor_parallel(graph, mesh, opts)
        elif route == "pose_sharded":
            solved, _, history = dist.solve_pose_sharded(graph, mesh, opts)
        elif route == "schur_cm":
            solved, _, history = dist.solve_schur_cm(graph, mesh, opts, **names)
        else:
            solved, _, history = dist.solve_schur_sharded(graph, mesh, opts, **names)
        return solved, history
    if route == "schur_large":
        solved, _, history = solve_schur_large(graph, opts, **names)
        return solved, history
    if route == "sparse_chol":
        return solve_sparse_chol(graph, opts)
    if route == "schur_sqrt":
        return solve_schur_sqrt(graph, opts, **names)
    if route == "schur_sparse":
        return solve_schur_sparse(graph, opts, **names)
    if route in ("schur_dense", "schur_pcg"):
        return solve_schur(graph, opts, mode=route.removeprefix("schur_"), **names)
    if route == "ell":
        return solve_ell(graph, opts)
    return solve(graph, opts)
