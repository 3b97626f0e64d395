"""Posterior covariance: blocks of H^-1 at the solved estimate.

Counterpart of ``pyslam_tpu/solver/covariance.py``, function for function:

  * ``full_covariance`` — the dense (D, D) inverse by a Cholesky solve
    against the identity (small and medium graphs; one dense H on the
    device).
  * ``marginal_covariances`` / ``covariance_block`` — (d, d) blocks of a
    single-block graph by column solves on the symmetric-ELL system: H
    assembled by ``bcsr.assemble_ell`` (the ``ell_assemble`` kernel on SE(3)
    pose graphs, ``slot_reduce`` elsewhere), every tangent column a
    block-Jacobi PCG solve.  The reference vmaps ``pcg_solve`` over the
    columns; here a block of columns is one ``cuda_ops.ell_pcg`` launch (up
    to the kernel's ``max_columns``, chunked on multiples of d so that a
    variable's columns stay together), each column with its own stop test.
  * ``marginal_covariances_direct`` / ``covariance_blocks_direct`` — exact
    blocks over the multifrontal factorization (``sparse_chol``): every
    diagonal block and the in-fill cross blocks in one selected-inverse
    sweep, or column solves of a block of unit vectors at once.
  * Bundle adjustment (``pose_marginal_covariances``,
    ``pose_covariance_block``, ``landmark_marginal_covariances``,
    ``landmark_covariance_block``, ``pose_landmark_covariance_block``) —
    (H^-1)_pp = S^-1 with S = Hpp + PP - W Hll^-1 W^T the reduced camera
    system, and the landmark blocks by the block-inverse identities
    Sigma_ll,ij = delta_ij (Hll^-1)_i + B_i^T S^-1 B_j, Sigma_pl = -S^-1 B_j
    with B_j = [W Hll^-1] block-column j.  ``method="pcg"``: S is never
    formed; a block of columns runs one PCG loop on the device
    (``schur_large._pcg``) over the implicit product of ``schur``'s sums
    (every sum by camera, landmark or pose a ``slot_reduce``), each column
    frozen from the iteration its stop test fails, the host reading whether
    any column still runs every 16 iterations.  ``method="sparse"``:
    S assembled into symmetric ELL (``schur_sparse``) and factored once.
    The B columns of all requested landmarks are one ``slot_reduce`` and one
    block of S-solves.

Either slot order of the observation batch, (pose, landmark) or (landmark,
pose), is taken: ``schur.ba_assemble`` takes both (the reference's
``ba_assemble`` only the first).  Constant variables return the unit
blocks of the masking, as in the reference.  Every function works on the
graph's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.core import FactorGraph
from .assemble import assemble_dense, unit_diag_where_dead_
from .bcsr import assemble_ell, build_ell_direct, ell_device_plan, sym_block_inv
from .cuda_ops import ell_pcg, ell_pcg_plan, slot_plan, slot_reduce
from .schur import _binv, _cholesky, ba_assemble, schur_block_diag
from .schur_large import _pcg
from .sparse_chol import _factorize, _solve_factored, build_chol_plan, selected_inverse_marginals

# Columns of one S-solve block: at most this many elements in the block's
# largest per-observation intermediate (M, dp, columns).
_S_BLOCK_ELEMENTS = 1 << 27


def _symmetrize(out):
    return 0.5 * (out + out.transpose(-1, -2))


def _unit_columns(col_ids, D, dtype, device):
    """(D, len(col_ids)) columns of the identity."""
    E = torch.zeros((D, len(col_ids)), dtype=dtype, device=device)
    E[torch.as_tensor(col_ids, device=device), torch.arange(len(col_ids), device=device)] = 1.0
    return E


def _diag_blocks(solve_cols, indices, n, d, chunk, dtype, device):
    """(k, d, d) diagonal blocks of the inverse for the variables
    ``indices`` of n variables of d dof: their columns solved ``chunk`` (a
    multiple of d) at a time by ``solve_cols`` ((n d, m) -> (n d, m)), each
    block read as the reference reads it (solved column a, row b: entry
    [a, b]) and symmetrized."""
    indices = np.asarray(indices, np.int64).reshape(-1)
    col_ids = (indices[:, None] * d + np.arange(d)[None, :]).reshape(-1)
    D = n * d
    per = max(1, chunk // d)
    out = []
    for s in range(0, len(indices), per):
        idx = indices[s:s + per]
        X = solve_cols(_unit_columns(col_ids[s * d:(s + len(idx)) * d], D, dtype, device))  # (D, k d)
        Xr = X.reshape(n, d, len(idx), d)
        out.append(Xr[torch.as_tensor(idx, device=device), :, torch.arange(len(idx), device=device), :]
                   .transpose(-1, -2))
    if not out:
        return torch.zeros((0, d, d), dtype=dtype, device=device)
    return _symmetrize(torch.cat(out))


# --------------------------------------------------------------------------
# Dense
# --------------------------------------------------------------------------


def full_covariance(graph: FactorGraph):
    """(D, D) posterior covariance over the free tangent space (constant
    parameters and dead dofs get unit rows from the masking): the dense H
    (``assemble_dense``), a unit diagonal where it is 0, and a Cholesky
    solve against the identity, on the graph's device.  NaN where H is not
    positive definite."""
    H, _, _ = assemble_dense(graph)
    unit_diag_where_dead_(H)
    L, info = torch.linalg.cholesky_ex(H)
    del H
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    X = torch.cholesky_solve(eye, L)
    return torch.where(info != 0, float("nan"), X)


# --------------------------------------------------------------------------
# Pose graphs: PCG column solves on the ELL system
# --------------------------------------------------------------------------


def _ell_col_solver(graph: FactorGraph, block_name: str, pcg_rtol, pcg_max_iters):
    """The shared column solver of a single-block graph: (solve_cols, nb, d,
    chunk), solve_cols((nb d, m)) -> H^-1 of those columns by the
    multi-column ``ell_pcg`` under the block-Jacobi preconditioner, chunk
    the columns a launch carries rounded down to a multiple of d (on the
    CPU the reference's 256)."""
    blk = graph.blocks[block_name]
    d = blk.dof
    plan = build_ell_direct(graph, block_name)
    dplan = ell_device_plan(plan, blk.values.device)
    He, _, _ = assemble_ell(graph, dplan)
    Minv = sym_block_inv(He[:, 0]).contiguous()
    cap = 256
    if He.device.type == "cuda":
        cap = ell_pcg_plan(plan.nb, plan.K, d, He.dtype, He.device)["max_columns"]
    chunk = max(d, cap - cap % d)

    def solve_cols(B):
        return ell_pcg(He, dplan.cols, Minv, B.contiguous(), pcg_rtol, pcg_max_iters).x

    return solve_cols, plan.nb, d, chunk


def _single_block(graph, block_name):
    if block_name is None:
        (block_name,) = graph.blocks.keys()
    return block_name


def marginal_covariances(
    graph: FactorGraph,
    block_name: str | None = None,
    indices=None,
    pcg_rtol: float = 1e-8,
    pcg_max_iters: int = 500,
):
    """(k, dof, dof) marginal covariance blocks of the selected variables
    (all where ``indices`` is None): H x = e_j for each tangent column j of
    each requested variable, by block-Jacobi PCG over the ELL system, a
    block of columns a launch.  No dense Hessian, no inverse."""
    block_name = _single_block(graph, block_name)
    blk = graph.blocks[block_name]
    if indices is None:
        indices = np.arange(blk.n)
    solve_cols, nb, d, chunk = _ell_col_solver(graph, block_name, pcg_rtol, pcg_max_iters)
    return _diag_blocks(solve_cols, indices, nb, d, chunk, blk.values.dtype, blk.values.device)


def covariance_block(
    graph: FactorGraph,
    i: int,
    j: int,
    block_name: str | None = None,
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
):
    """(dof, dof) cross-covariance block Sigma_ij of H^-1 between elements
    ``i`` and ``j`` of a single-block graph, by the ``dof`` column solves of
    element j (one launch); never forms a dense (D, D)."""
    block_name = _single_block(graph, block_name)
    solve_cols, nb, d, _ = _ell_col_solver(graph, block_name, pcg_rtol, pcg_max_iters)
    blk = graph.blocks[block_name]
    X = solve_cols(_unit_columns(j * d + np.arange(d), nb * d, blk.values.dtype, blk.values.device))
    return X.reshape(nb, d, d)[i]


# --------------------------------------------------------------------------
# Pose graphs: the multifrontal factorization
# --------------------------------------------------------------------------


def _plan_and_factors(graph, block_name, plan, leaf_size, factors=None):
    """The shared head of the direct entry points: the block, the
    multifrontal plan (built or the caller's), and the factors (computed
    from ``assemble_ell``, or the caller's, for repeated online queries)."""
    block_name = _single_block(graph, block_name)
    if plan is None:
        plan = build_chol_plan(graph, block_name, leaf_size=leaf_size)
    if factors is None:
        He, _, _ = assemble_ell(graph, ell_device_plan(plan.ell, graph.blocks[block_name].values.device))
        factors = _factorize(plan, He)
    return block_name, plan, factors


def marginal_covariances_direct(
    graph: FactorGraph,
    block_name: str | None = None,
    indices=None,
    plan=None,
    leaf_size: int = 32,
    factors=None,
):
    """(k, dof, dof) marginal covariance blocks, exact, via the
    multifrontal factorization (``sparse_chol``): all of them (``indices``
    None) by the selected-inverse sweep, about twice the factorization's
    cost; a subset by triangular solves of their unit columns, 128 - 128 %
    dof columns a block."""
    block_name, plan, factors = _plan_and_factors(graph, block_name, plan, leaf_size, factors)
    if indices is None:
        return _symmetrize(selected_inverse_marginals(plan, factors))
    d = graph.blocks[block_name].dof
    L0 = factors[0][0]
    return _diag_blocks(lambda B: _solve_factored(plan, factors, B), indices, plan.nb, d, max(d, 128 - 128 % d),
                        L0.dtype, L0.device)


def covariance_blocks_direct(
    graph: FactorGraph,
    pairs,
    block_name: str | None = None,
    plan=None,
    leaf_size: int = 32,
    factors=None,
):
    """((k, d, d) marginals of every variable, (len(pairs), d, d) cross
    blocks Sigma_uv) for (u, v) pairs within the factorization fill, from
    one selected-inverse sweep.  Original graph edges (odometry pairs) are
    always in the fill; an out-of-fill pair raises ValueError (use
    ``covariance_block``)."""
    block_name, plan, factors = _plan_and_factors(graph, block_name, plan, leaf_size, factors)
    diag, blocks = selected_inverse_marginals(plan, factors, pairs=pairs)
    return _symmetrize(diag), blocks


# --------------------------------------------------------------------------
# Bundle adjustment: the reduced camera system
# --------------------------------------------------------------------------


def _reduced_pieces(graph, pose_name, lm_name):
    """The shared head of the S-solvers: ``ba_assemble``'s parts (GN, no
    damping), Hll^-1, and the aux dict the landmark identities read (C, dp,
    Hll_inv, W, the plan, the observations' cameras and landmarks on the
    host)."""
    parts, _, _ = ba_assemble(graph, pose_name, lm_name)
    plan = parts["plan"]
    Hll_inv = _binv(_cholesky(parts["Hll"]))
    aux = dict(C=plan.C, dp=plan.dp, Hll_inv=Hll_inv, W=parts["W"], plan=plan,
               ci=plan.cam_idx.cpu().numpy(), li=plan.pt_idx.cpu().numpy())
    return parts, Hll_inv, aux


def schur_column_matvec(plan, Hpp, Hll_inv, W, PP, cam_sum=None):
    """X (C dp, m) -> S X with S = Hpp + PP couplings - W Hll^-1 W^T never
    formed: ``schur.schur_matvec`` on a block of columns (two gathers, the
    sums by landmark and by camera and, with couplings, by either pose, all
    ``slot_reduce``, d*m wide).  ``cam_sum`` as in
    ``schur._schur_reduce``."""
    C, dp = Hpp.shape[0], Hpp.shape[-1]
    cam_sum = cam_sum or plan.by_cam.sum

    # Batched ``@`` here, not ``schur``'s broadcast products: with m columns
    # those would hold (M, dp, dl, m) intermediates, m times W's size.
    def matvec(X):
        xb = X.reshape(C, dp, -1)
        y = Hpp @ xb
        if PP.shape[0]:  # pose-pose coupling (full-SLAM between factors)
            y = y + plan.by_pp_i.sum(PP @ xb[plan.pp_j])
            y = y + plan.by_pp_j.sum(PP.transpose(-1, -2) @ xb[plan.pp_i])
        t = Hll_inv @ plan.by_lm.sum(W.transpose(-1, -2) @ xb[plan.cam_idx])
        y = y - cam_sum(W @ t[plan.pt_idx])
        return y.reshape(C * dp, -1)

    return matvec


def _s_block_columns(M, C, dp):
    """Columns of one S-solve block, a multiple of dp: the (M, dp, m)
    intermediates of a product stay under ``_S_BLOCK_ELEMENTS``."""
    cols = _S_BLOCK_ELEMENTS // max(1, max(M, C) * dp)
    return max(dp, cols - cols % dp)


def _S_pcg_solver(plan, Hpp, Hll_inv, W, PP, pcg_rtol, pcg_max_iters, cam_sum=None, block=None):
    """solve_rhs(B (C dp, m)) -> S^-1 B by ``schur_large._pcg`` over
    ``schur_column_matvec``, under the block inverse of S's diagonal (the
    self-loop couplings folded in, so it stays the exact diagonal), in
    blocks of ``block`` columns (None: ``_s_block_columns``; ranks that sum
    over each other pass the same number)."""
    C, dp = Hpp.shape[0], Hpp.shape[-1]
    D = schur_block_diag(plan, Hpp, Hll_inv, W, cam_sum)
    if PP.shape[0]:
        selfloop = (plan.pp_i == plan.pp_j).to(PP.dtype)[:, None, None]
        D = D + plan.by_pp_i.sum(selfloop * (PP + PP.transpose(-1, -2)))
    D_inv = _binv(_cholesky(D))
    matvec = schur_column_matvec(plan, Hpp, Hll_inv, W, PP, cam_sum)

    def precond(R):
        return (D_inv @ R.reshape(C, dp, -1)).reshape(C * dp, -1)

    if block is None:
        block = _s_block_columns(W.shape[0], C, dp)

    # the host reads whether any column still runs every 16 iterations; the
    # columns' results do not depend on it (a stopped column is frozen)
    def solve_rhs(B):
        return torch.cat([_pcg(matvec, precond, B[:, s:s + block].contiguous(), pcg_rtol, pcg_max_iters,
                               read_every=16)[0]
                          for s in range(0, B.shape[1], block)], 1) if B.shape[1] else B.clone()

    return solve_rhs


def _schur_S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters):
    """S-solves by PCG on the implicit reduced camera system: (solve_rhs,
    aux).  By the block-inverse identity (H^-1)_pose-pose = S^-1, so pose
    covariances come from S-solves, the landmark side staying as batched
    dl x dl inverses.  The pose-pose couplings PP of full-SLAM graphs are
    part of S and enter the product."""
    parts, Hll_inv, aux = _reduced_pieces(graph, pose_name, lm_name)
    solve_rhs = _S_pcg_solver(parts["plan"], parts["Hpp"], Hll_inv, parts["W"], parts["PP"], pcg_rtol,
                              pcg_max_iters)
    return solve_rhs, aux


def _schur_S_solver_sparse(graph, pose_name, lm_name, leaf_size=32):
    """The exact variant of ``_schur_S_solver``: S assembled into symmetric
    ELL (``schur_sparse``) and factored once by the multifrontal Cholesky;
    every block of S-solves is then two level-scheduled triangular solves.
    The factors also serve the all-poses selected-inverse sweep."""
    from .schur_sparse import assemble_S_ell, build_schur_sparse_plan, plan_tables

    parts, Hll_inv, aux = _reduced_pieces(graph, pose_name, lm_name)
    plan = build_schur_sparse_plan(graph, pose_name, lm_name, leaf_size)
    tables = plan_tables(plan, Hll_inv.device)
    He = assemble_S_ell(plan, tables, parts["Hpp"], parts["PP"], parts["W"], Hll_inv)
    factors = _factorize(plan.chol, He)
    aux["chol_plan"] = plan.chol
    aux["chol_factors"] = factors

    def solve_rhs(B):
        return _solve_factored(plan.chol, factors, B.contiguous())

    return solve_rhs, aux


def _S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters, method):
    if method == "sparse":
        return _schur_S_solver_sparse(graph, pose_name, lm_name)
    if method != "pcg":
        raise ValueError(f"unknown S-solver method {method!r} ('pcg' | 'sparse')")
    return _schur_S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters)


def pose_marginal_covariances(
    graph: FactorGraph,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    indices=None,
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
    method: str = "pcg",
):
    """(k, dp, dp) pose marginal covariances of a BA graph from the reduced
    camera system, (H^-1)_pp = S^-1: S-solves of the poses' unit columns,
    or, for all poses with ``method="sparse"``, the selected-inverse sweep
    over the factored S.  Constant (gauge-anchor) poses return the unit
    block of ``ba_assemble``'s masking."""
    solve_rhs, aux = _S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters, method)
    C, dp = aux["C"], aux["dp"]
    if indices is None and method == "sparse":
        return _symmetrize(selected_inverse_marginals(aux["chol_plan"], aux["chol_factors"]))
    if indices is None:
        indices = np.arange(C)
    W = aux["W"]
    chunk = max(dp, len(np.atleast_1d(indices)) * dp)
    return _diag_blocks(solve_rhs, indices, C, dp, chunk, W.dtype, W.device)


def pose_covariance_block(
    graph: FactorGraph,
    i: int,
    j: int,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
    method: str = "pcg",
):
    """(dp, dp) pose-pose cross-covariance block (S^-1)_ij of a BA graph."""
    solve_rhs, aux = _S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters, method)
    C, dp, W = aux["C"], aux["dp"], aux["W"]
    X = solve_rhs(_unit_columns(j * dp + np.arange(dp), C * dp, W.dtype, W.device))
    return X.reshape(C, dp, dp)[i]


def _landmark_B(aux, indices):
    """B_i = [W Hll^-1] block-column i of each landmark of ``indices``, side
    by side as (C dp, k dl) (nonzero only at the cameras observing it), and
    (Hll^-1)_ii (k, dl, dl).  The rows W_m Hll^-1_i of the observations of
    the k landmarks are summed by (landmark, camera) with one
    ``slot_reduce`` over a plan built here on the host and written to their
    unique positions.  Also returns whether each landmark is observed."""
    C, dp = aux["C"], aux["dp"]
    Hll_inv, W = aux["Hll_inv"], aux["W"]
    ci, li = aux["ci"], aux["li"]
    dl = Hll_inv.shape[-1]
    indices = np.asarray(indices, np.int64).reshape(-1)
    k = len(indices)
    device = W.device
    Hi = Hll_inv[torch.as_tensor(indices, device=device)]
    # every observation of a requested landmark, once per request
    where = [np.flatnonzero(li == int(i)) for i in indices]
    obs = np.concatenate(where) if k else np.zeros(0, np.int64)
    slot = np.repeat(np.arange(k), [len(w) for w in where])
    B = torch.zeros((k, C, dp, dl), dtype=W.dtype, device=device)
    if len(obs):
        dest, sums = np.unique(slot * C + ci[obs], return_inverse=True)
        sp = slot_plan(sums.reshape(-1), len(dest))
        t = torch.as_tensor(slot, device=device)
        rows = (W[torch.as_tensor(obs, device=device)] @ Hi[t]).reshape(len(obs), dp * dl)
        summed = slot_reduce(rows.contiguous(), torch.as_tensor(sp.perm, device=device),
                             torch.as_tensor(sp.offsets, device=device), len(dest), sp.longest)
        B.view(k * C, dp, dl)[torch.as_tensor(dest, device=device)] = summed.reshape(-1, dp, dl)
    observed = np.array([len(w) > 0 for w in where], bool)
    return B.permute(1, 2, 0, 3).reshape(C * dp, k * dl), Hi, observed


def landmark_marginal_covariances(
    graph: FactorGraph,
    indices,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
    method: str = "pcg",
):
    """(k, dl, dl) landmark marginal covariances of a BA graph by the
    block-inverse identity Sigma_ll,ii = (Hll^-1)_ii + B_i^T S^-1 B_i: the
    dl columns of every requested landmark's B_i in one block of S-solves.
    An unobserved landmark returns its masked unit block."""
    solve_rhs, aux = _S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters, method)
    B, Hi, observed = _landmark_B(aux, indices)
    k, dl = Hi.shape[0], Hi.shape[-1]
    X = solve_rhs(B)  # (C dp, k dl)
    Bk = B.reshape(-1, k, dl).transpose(0, 1)  # (k, C dp, dl)
    Xk = X.reshape(-1, k, dl).transpose(0, 1)
    cov = _symmetrize(Hi + Bk.transpose(-1, -2) @ Xk)
    return torch.where(torch.as_tensor(observed, device=Hi.device)[:, None, None], cov, Hi)


def landmark_covariance_block(
    graph: FactorGraph,
    lm_i: int,
    lm_j: int,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
    method: str = "pcg",
):
    """(dl, dl) landmark-landmark covariance block of H^-1, cross blocks
    included: Sigma_ll',ij = delta_ij (Hll^-1)_i + B_i^T S^-1 B_j, the dl
    S-solves of B_j.  An unobserved landmark is decoupled from
    everything."""
    solve_rhs, aux = _S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters, method)
    B, H, observed = _landmark_B(aux, [lm_i, lm_j])
    dl = H.shape[-1]
    delta = H[0] if lm_i == lm_j else torch.zeros((dl, dl), dtype=H.dtype, device=H.device)
    if not observed.all():
        return delta
    Bi, Bj = B[:, :dl], B[:, dl:]
    cov = delta + Bi.transpose(0, 1) @ solve_rhs(Bj)
    return _symmetrize(cov) if lm_i == lm_j else cov


def pose_landmark_covariance_block(
    graph: FactorGraph,
    pose_i: int,
    lm_j: int,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
    method: str = "pcg",
):
    """(dp, dl) pose-landmark cross-covariance block of H^-1: by the block
    inverse Sigma_pl = -S^-1 [W Hll^-1], the pose-i rows of -S^-1 B_j."""
    solve_rhs, aux = _S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters, method)
    dp = aux["dp"]
    B, H, observed = _landmark_B(aux, [lm_j])
    if not observed[0]:
        return torch.zeros((dp, H.shape[-1]), dtype=H.dtype, device=H.device)
    return -solve_rhs(B)[pose_i * dp:(pose_i + 1) * dp]


__all__ = [
    "full_covariance",
    "marginal_covariances",
    "marginal_covariances_direct",
    "covariance_blocks_direct",
    "covariance_block",
    "pose_marginal_covariances",
    "pose_covariance_block",
    "landmark_marginal_covariances",
    "landmark_covariance_block",
    "pose_landmark_covariance_block",
]
