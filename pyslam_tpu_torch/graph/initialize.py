"""Pose-graph initialization: spanning-tree odometry integration and the
chordal relaxation.

Counterpart of ``pyslam_tpu/graph/initialize.py``.  ``spanning_tree_init``
and ``_project_rotations`` are host numpy, copied unchanged.
``chordal_init`` builds its two linear stages as ``FactorGraph``s over one
euclidean block (the ``chordal_rot`` / ``chordal_trans`` kinds of
``graph/factor_defs.py``) in the caller's ``dtype`` on the caller's
``device``, and solves each with one exact GN step; the SVD projection runs
on the host.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .._device import resolve_device

# The stages' solver: the dense path up to this many dof, else ELL PCG.
STAGE_DENSE_DOF = 12000


def spanning_tree_init(
    edges_i, edges_j, T_meas, n_poses: int, root: int = 0, T_root=None
):
    """Initial poses by BFS spanning-tree integration of edge measurements.

    ``T_meas[k]`` is the usual between-factor measurement T_j_i (pose i
    expressed in pose j's frame), matching io.synth / io.g2o conventions:
    along a tree edge i->j, ``T_j = T_meas[k] @ T_i``.

    Returns (N, d+1, d+1) poses; unreachable poses get the root pose.
    """
    edges_i = np.asarray(edges_i)
    edges_j = np.asarray(edges_j)
    T_meas = np.asarray(T_meas)
    dim = T_meas.shape[-1]
    if T_root is None:
        T_root = np.eye(dim)

    # adjacency with edge ids and direction
    adj: list[list] = [[] for _ in range(n_poses)]
    for k, (i, j) in enumerate(zip(edges_i, edges_j)):
        adj[int(i)].append((int(j), k, False))
        adj[int(j)].append((int(i), k, True))

    T = np.tile(np.asarray(T_root, np.float64), (n_poses, 1, 1))
    seen = np.zeros(n_poses, bool)
    seen[root] = True
    q = deque([root])
    T_inv = {}
    while q:
        u = q.popleft()
        for v, k, reverse in adj[u]:
            if seen[v]:
                continue
            seen[v] = True
            if reverse:
                if k not in T_inv:
                    T_inv[k] = np.linalg.inv(T_meas[k])
                T[v] = T_inv[k] @ T[u]
            else:
                T[v] = T_meas[k] @ T[u]
            q.append(v)
    return T


def _project_rotations(R):
    """Nearest SO(d) projection of a batch of (N, d, d) matrices (SVD)."""
    U, _, Vt = np.linalg.svd(R)
    Rp = U @ Vt
    # fix improper rotations: flip the smallest singular direction
    neg = np.linalg.det(Rp) < 0
    if neg.any():
        U = U.copy()
        U[neg, :, -1] *= -1.0
        Rp[neg] = U[neg] @ Vt[neg]
    return Rp


def _stage_graph(name, x0, anchor, kind, edges_i, edges_j, data, dtype, device):
    """One chordal stage: a euclidean block ``name`` with the anchor frozen
    and one batch of ``kind`` over its (i, j) pairs."""
    from ..losses import L2Loss
    from .core import FactorBatch, FactorGraph, VariableBlock

    const = torch.zeros(x0.shape[0], dtype=torch.bool, device=device)
    const[anchor] = True
    block = VariableBlock.create("euclidean", torch.as_tensor(x0, dtype=dtype).to(device), const)
    batch = FactorBatch.create(
        kind=kind,
        slots=(name, name),
        indices=(edges_i, edges_j),
        data={k: torch.as_tensor(v, dtype=dtype).to(device) for k, v in data.items()},
        loss=L2Loss(),
    )
    return FactorGraph({name: block}, [batch])


def _rotation_graph(edges_i, edges_j, R_meas, n_poses, anchor, R_anchor, dtype, device):
    """Stage 1: the rotation relaxation, a d*d-dof euclidean variable
    vec(R^T) per pose, started at the identity (the anchor at its own)."""
    d = R_meas.shape[-1]
    x0 = np.tile(np.eye(d).T.reshape(-1), (n_poses, 1))
    x0[anchor] = np.asarray(R_anchor).T.reshape(-1)
    return _stage_graph("rot", x0, anchor, "chordal_rot", edges_i, edges_j, {"R_meas": R_meas}, dtype, device)


def _translation_graph(edges_i, edges_j, R_meas, t_meas, n_poses, anchor, t_anchor, dtype, device):
    """Stage 2: translation recovery with the rotations fixed, started at
    zero (the anchor at its own)."""
    t0 = np.zeros((n_poses, R_meas.shape[-1]))
    t0[anchor] = t_anchor
    return _stage_graph("t", t0, anchor, "chordal_trans", edges_i, edges_j,
                        {"R_meas": R_meas, "t_meas": t_meas}, dtype, device)


def _solve_stage(g, opts, pcg_rtol, pcg_max_iters):
    """Dense exact up to ``STAGE_DENSE_DOF``; ELL PCG above.  Deliberately
    not ``route_auto``: it sends large 3-dof euclidean blocks to the
    multifrontal path, whose planning cost is out of place in a one-shot
    initializer that tolerates rtol 1e-6."""
    from ..solver import solve_auto
    from ..solver.bcsr import solve_ell

    if g.total_dof <= STAGE_DENSE_DOF:
        return solve_auto(g, opts)
    return solve_ell(g, opts, pcg_rtol=pcg_rtol, pcg_max_iters=pcg_max_iters)


def chordal_init(
    edges_i,
    edges_j,
    T_meas,
    n_poses: int,
    anchor: int = 0,
    T_anchor=None,
    dtype=torch.float64,
    device=None,
    pcg_rtol: float = 1e-6,
    pcg_max_iters: int = 250,
):
    """Chordal initialization (Carlone et al., ICRA 2015): relax rotations
    to arbitrary d x d matrices, solve the linear least squares
    sum_k || R_j - R_meas_k R_i ||_F^2, project each solution to SO(d), then
    recover translations from sum_k || t_j - R_meas_k t_i - t_meas_k ||^2
    with the rotations fixed.  Closer to the optimum's basin than
    odometry or spanning-tree integration on loopy graphs.

    Both stages are FactorGraphs in ``dtype`` on ``device`` (None: the
    package's default, the CUDA card), each solved by one exact GN step
    (``Options(method="gn", max_iters=3, min_cost_decrease=0.999)``) on the
    dense path up to ``STAGE_DENSE_DOF`` dof, else by ``solve_ell`` with
    ``pcg_rtol`` / ``pcg_max_iters``.  Each stage's solution is read to the
    host once.

    Returns (n_poses, d+1, d+1) float64 poses (numpy).
    """
    from ..solver import Options

    device = resolve_device(device)
    edges_i = np.asarray(edges_i)
    edges_j = np.asarray(edges_j)
    T_meas = np.asarray(T_meas, np.float64)
    d = T_meas.shape[-1] - 1
    R_meas = T_meas[:, :d, :d]
    t_meas = T_meas[:, :d, d]
    if T_anchor is None:
        T_anchor = np.eye(d + 1)
    T_anchor = np.asarray(T_anchor, np.float64)
    opts = Options(method="gn", max_iters=3, min_cost_decrease=0.999)

    g_rot = _rotation_graph(edges_i, edges_j, R_meas, n_poses, anchor, T_anchor[:d, :d], dtype, device)
    solved_rot, _ = _solve_stage(g_rot, opts, pcg_rtol, pcg_max_iters)
    X = solved_rot.blocks["rot"].values.cpu().numpy().astype(np.float64).reshape(n_poses, d, d)
    R = _project_rotations(np.swapaxes(X, -1, -2))
    R[anchor] = T_anchor[:d, :d]

    g_t = _translation_graph(edges_i, edges_j, R_meas, t_meas, n_poses, anchor, T_anchor[:d, d], dtype, device)
    solved_t, _ = _solve_stage(g_t, opts, pcg_rtol, pcg_max_iters)
    t = solved_t.blocks["t"].values.cpu().numpy().astype(np.float64)

    T = np.tile(np.eye(d + 1), (n_poses, 1, 1))
    T[:, :d, :d] = R
    T[:, :d, d] = t
    return T


__all__ = ["spanning_tree_init", "chordal_init"]
