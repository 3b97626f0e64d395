"""Landmark-sharded Schur-complement bundle adjustment (bench config 5's
path).

Counterpart of ``pyslam_tpu/dist/schur_reduce.py`` (``ShardedBA``,
``shard_ba``, ``make_sharded_schur_step``, ``solve_schur_sharded``, with
its checkpoint, resume and elastic-recovery contract).  Layout:

  * camera poses — replicated (C is small against L);
  * landmarks — split over the ranks by a partition (balanced contiguous
    blocks by default), each rank holding its own ``Lr``;
  * observations — on the rank that owns their landmark, so the whole
    landmark elimination (Hll, its 3 x 3 inverses, the back-substitution)
    is local to the rank;
  * the reduced camera system — replicated and solved by PCG; one product
    with S is the rank's gathers and ``slot_reduce`` sums plus one
    ``mesh.psum`` of a camera-side array.

Every segment sum (by camera, by landmark, the pose-unary and (pose, pose)
batches by pose) is ``slot_reduce`` over a plan built once in
``shard_ba``.  Every ``jax.lax.psum`` of the reference is a ``mesh.psum``
of a camera-side array; the cost, the camera blocks and the camera
gradient, which the reference sums one after the other, go into one
collective, and so do the update norm and the trial cost.  A rank holds
its own sizes: the reference pads landmark slabs and observations with
safe points because ``shard_map`` needs equal shapes; here only the gather
of the landmarks (checkpoint, result) pads, inside ``mesh.all_gather``.

Posterior covariance over the same layout (``sharded_pose_marginals``,
``sharded_landmark_marginals``): the GN pieces at the graph's estimate,
then S-solves of ``solver/covariance.py`` whose product sums by camera
with one ``psum`` an application; a landmark's B_i and (Hll^-1)_ii are
built on its owner rank and replicated by one ``psum``.

The Schur algebra is ``solver/schur.py``'s, through
``schur_large._solve_pcg`` with a ``cam_sum`` that follows every sum by
camera with a ``psum``: the masks (``mask_constants``), the damping and
Hll⁻¹ (``_schur_reduce``), the block diagonal of S (``schur_block_diag``),
the implicit product (``schur_matvec``), the back-substitution.  PCG on the
replicated camera system is ``schur_large._pcg``: the stop test is applied
on the device and read every ``schur_large.CG_READ_EVERY`` iterations
(never, by default), and the all-reduced vectors are the same on every
rank, so the frozen iterates agree.  The LM loop is the shared host loop:
one host read an LM iteration, of all-reduced values, so every rank takes
the same branch.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..graph.core import FACTOR_KERNELS, FactorBatch, FactorGraph, VariableBlock, retract
from ..solver import covariance as _cov
from ..solver import lm as _lm
from ..solver.host_loop import host_lm_loop
from ..solver.schur import Segments, _back_substitute, _binv, _cholesky, _jtwj, _tmv, mask_constants
from ..solver.schur_large import _host_index, _segments, _solve_pcg, _unary
from .mesh import Mesh
from .partitioner import Partition, partition_landmarks


@dataclasses.dataclass
class ShardedBA:
    """One rank's plan of a camera / landmark graph, on ``mesh.device``.
    Its index fields are named as ``schur.mask_constants`` and
    ``schur._back_substitute`` read them."""

    mesh: Mesh
    kind: str  # the observation batch's factor kind
    pose_kind: str  # the pose manifold ('se3' | 'se2' | 'sim3' | 'bal_cam9')
    pose_first: bool  # the observation batch's slots are (pose, landmark)
    loss: object
    C: int
    L: int  # landmarks of the whole graph
    dp: int
    dl: int
    lm_counts: tuple  # landmarks of each rank
    lm_order: np.ndarray  # (L,) the landmarks, rank after rank: rank r's are its own in this order
    lm_local: np.ndarray  # (Lr,) this rank's landmarks
    poses: torch.Tensor  # (C, ...) replicated
    free_p: torch.Tensor  # (C,) 1.0 free, 0.0 constant
    lms: torch.Tensor  # (Lr, dl)
    free_l: torch.Tensor  # (Lr,)
    obs_data: dict  # this rank's observations' data; values without the observation axis as given
    weight: torch.Tensor  # (Mr,)
    cam_idx: torch.Tensor  # (Mr,) int64, camera of each observation
    pt_idx: torch.Tensor  # (Mr,) int64, its landmark's row in ``lms``
    by_cam: Segments  # the Mr observations by camera
    by_lm: Segments  # ... by local landmark
    unary: tuple  # the pose-unary and (pose, pose) batches, replicated
    by_pose_u: Segments  # their Hessian and gradient rows by pose
    pp_i: torch.Tensor  # (E,) the (pose, pose) factors, int64
    pp_j: torch.Tensor
    by_pp_i: Segments
    by_pp_j: Segments


def _batch_to(fb: FactorBatch, device) -> FactorBatch:
    return FactorBatch(fb.kind, fb.slots, tuple(i.to(device) for i in fb.indices),
                       {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in fb.data.items()},
                       fb.loss, fb.weight.to(device))


def rank_batch(fb: FactorBatch, mine: np.ndarray, indices, device) -> FactorBatch:
    """The observations ``mine`` (graph order) of ``fb`` with ``indices``,
    on ``device``; the whole batch's tensors where ``mine`` is all of it."""
    M = fb.n
    everything = len(mine) == M  # mine is ascending, so then it is arange(M)
    at = None if everything else torch.as_tensor(mine, device=fb.weight.device)

    def take(v):
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == M:
            return (v if everything else v[at]).to(device)
        return v.to(device) if torch.is_tensor(v) else v

    return FactorBatch(fb.kind, fb.slots, tuple(torch.as_tensor(i, device=device) for i in indices),
                       {k: take(v) for k, v in fb.data.items()}, fb.loss, take(fb.weight))


def landmark_shares(partition: Partition | None, L: int, mesh: Mesh, who: str):
    """(part, lm_order, counts, local_row, lm_local) of a landmark partition
    (the balanced contiguous one where None) over ``mesh``: each landmark's
    rank, the landmarks rank after rank, each rank's count, each landmark's
    row in its owner's share, and this rank's landmarks in graph order.
    Raises ValueError for a partition of other sizes or ranks."""
    n = mesh.size
    if partition is None:
        partition = partition_landmarks(None, None, L, n_parts=n)
    part = np.asarray(partition.part, np.int64)
    if len(part) != L or partition.n_parts != n or (L and (part.min() < 0 or part.max() >= n)):
        raise ValueError(f"{who}: a partition of {L} landmarks into {n} parts expected")
    lm_order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    local_row = np.empty(L, np.int64)  # a landmark's row in its owner's share
    local_row[lm_order] = np.arange(L) - starts[part[lm_order]]
    return part, lm_order, counts, local_row, lm_order[starts[mesh.rank]:starts[mesh.rank] + counts[mesh.rank]]


def split_ba(graph: FactorGraph, mesh: Mesh, pose_name: str, lm_name: str, partition: Partition | None, who: str):
    """The host split of a BA graph over ``mesh`` that ``shard_ba`` and
    ``schur_cm.shard_ba_cm`` share: (fb, rep, rep_idx, pose_first, lm_order,
    counts, lm_local, mine, (cam, row)).  ``fb`` is the one observation
    batch (either slot order), ``rep`` the pose-unary and (pose, pose)
    batches with ``rep_idx`` their indices, every index checked against its
    block's size (ValueError for any other batch or an index out of
    range); the landmark shares are ``landmark_shares``'s; ``mine`` are this
    rank's observations in graph order, ``cam`` their cameras and ``row``
    their landmarks' rows in the rank's share."""
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    C, L = pb.n, lb.n
    obs = [fb for fb in graph.batches if tuple(fb.slots) in ((pose_name, lm_name), (lm_name, pose_name))]
    rep = [fb for fb in graph.batches if tuple(fb.slots) in ((pose_name,), (pose_name, pose_name))]
    if len(obs) != 1 or len(obs) + len(rep) != len(graph.batches):
        raise ValueError(f"{who} supports exactly one pose-landmark batch plus pose-unary and pose-pose batches")
    (fb,) = obs
    pose_first = tuple(fb.slots) == (pose_name, lm_name)
    rep_idx = [[_host_index(i, C, f"factor batch {u.kind!r} slot {pose_name!r}") for i in u.indices] for u in rep]

    part, lm_order, counts, local_row, lm_local = landmark_shares(partition, L, mesh, who)
    cam_t, pt_t = fb.indices if pose_first else fb.indices[::-1]
    cam = _host_index(cam_t, C, f"factor batch {fb.kind!r} slot {pose_name!r}")
    pt = _host_index(pt_t, L, f"factor batch {fb.kind!r} slot {lm_name!r}")
    mine = np.flatnonzero(part[pt] == mesh.rank)
    return fb, rep, rep_idx, pose_first, lm_order, counts, lm_local, mine, (cam[mine], local_row[pt[mine]])


def shard_ba(
    graph: FactorGraph,
    mesh: Mesh,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    partition: Partition | None = None,
) -> ShardedBA:
    """This rank's plan of a BA graph: one observation batch (either slot
    order), otherwise pose-unary and (pose, pose) batches.  Built on the
    host, the same on every rank; only the rank's share goes to
    ``mesh.device``."""
    device = mesh.device
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    C, dp, L, dl = pb.n, pb.dof, lb.n, lb.dof
    fb, rep, rep_idx, pose_first, lm_order, counts, lm_local, mine, (cam_l, pt_l) = split_ba(
        graph, mesh, pose_name, lm_name, partition, "shard_ba")
    ob = rank_batch(fb, mine, (cam_l, pt_l), device)

    def cat(arrays):
        return np.concatenate(arrays) if arrays else np.zeros(0, np.int64)

    pi = cat([idx[0] for idx in rep_idx if len(idx) == 2])
    pj = cat([idx[1] for idx in rep_idx if len(idx) == 2])
    at = torch.as_tensor(lm_local, device=lb.values.device)
    dtype = pb.values.dtype
    return ShardedBA(
        mesh=mesh, kind=fb.kind, pose_kind=pb.kind, pose_first=pose_first, loss=fb.loss, C=C, L=L, dp=dp, dl=dl,
        lm_counts=tuple(int(c) for c in counts), lm_order=lm_order, lm_local=lm_local,
        poses=pb.values.to(device), free_p=(~pb.const_mask).to(device, dtype),
        lms=lb.values[at].to(device), free_l=(~lb.const_mask[at]).to(device, dtype),
        obs_data=ob.data, weight=ob.weight, cam_idx=ob.indices[0], pt_idx=ob.indices[1],
        by_cam=_segments(cam_l, C, device), by_lm=_segments(pt_l, len(lm_local), device),
        unary=tuple(_batch_to(u, device) for u in rep), by_pose_u=_segments(cat(sum(rep_idx, [])), C, device),
        pp_i=torch.as_tensor(pi, device=device), pp_j=torch.as_tensor(pj, device=device),
        by_pp_i=_segments(pi, C, device), by_pp_j=_segments(pj, C, device),
    )


def _observations(sb, poses, lms, want_grad):
    """Residuals and (camera, landmark) Jacobians of the rank's observations."""
    T, X = poses[sb.cam_idx], lms[sb.pt_idx]
    r, jacs = FACTOR_KERNELS[sb.kind](sb.obs_data, *((T, X) if sb.pose_first else (X, T)),
                                      compute_jacobians=want_grad)
    if want_grad and not sb.pose_first:
        jacs = jacs[::-1]
    return r, jacs


def _rows(J, w, wr):
    """Per observation, J^T w r and the entries of J^T diag(w) J, side by side."""
    return torch.cat([_tmv(J, wr), _jtwj(J, w, J).reshape(J.shape[0], J.shape[-1] ** 2)], 1)


def make_sharded_schur_step(sb: ShardedBA, options: _lm.Options, pcg_rtol: float = 1e-8, pcg_max_iters: int = 200):
    """One landmark-sharded Schur LM iteration.

    ``step((poses, lms), lam) -> ((new_poses, new_lms), chi2, cost_new,
    dx_norm)``: ``lms`` the rank's landmarks, the costs and the update norm
    summed over the ranks.  The Schur algebra is ``schur_large._solve_pcg``'s
    with every sum by camera followed by a ``psum``.  Collectives: one for
    the cost and the camera blocks and gradient, one for the reduced
    gradient, one for the block diagonal of S, one a CG iteration, one for
    the update norm and the trial cost."""
    mesh, C, dp, dl = sb.mesh, sb.C, sb.dp, sb.dl
    loss, w_obs = sb.loss, sb.weight[:, None]

    def cam_sum(rows):
        return mesh.psum(sb.by_cam.sum(rows))

    def step(state, lam):
        poses, lms = state
        r, (Jc, Jl) = _observations(sb, poses, lms, True)
        w = loss.weight(r) * w_obs
        wr = w * r
        cam = sb.by_cam.sum(_rows(Jc, w, wr))
        red = mesh.psum(torch.cat([torch.sum(loss.loss(r) * w_obs).reshape(1), cam.reshape(-1)]))
        c_u, H_u, g_u, PP = _unary(sb, poses, True, dp)
        chi2 = red[0] + c_u
        cam = red[1:].reshape(C, dp + dp * dp)
        lm = sb.by_lm.sum(_rows(Jl, w, wr))
        Hpp, g_p, Hll, g_l, W, PP = mask_constants(
            sb, cam[:, dp:].reshape(C, dp, dp) + H_u, -cam[:, :dp] - g_u, lm[:, dl:].reshape(lm.shape[0], dl, dl),
            -lm[:, :dl], _jtwj(Jc, w, Jl), PP, sb.free_p, sb.free_l)
        del r, Jc, Jl, w, wr
        parts = dict(Hpp=Hpp, g_p=g_p, Hll=Hll, g_l=g_l, W=W, PP=PP, plan=sb)
        Hll_inv, x = _solve_pcg(parts, lam, options.method, pcg_rtol, pcg_max_iters, cam_sum)
        dx_p = x.reshape(C, dp) * sb.free_p[:, None]
        dx_l = _back_substitute(Hll_inv, W, sb, g_l, dx_p)

        new_poses = retract(sb.pose_kind, poses, dx_p)
        new_lms = lms + dx_l
        r_new, _ = _observations(sb, new_poses, new_lms, False)
        tail = mesh.psum(torch.stack([torch.sum(dx_l**2), torch.sum(loss.loss(r_new) * w_obs)]))
        dx_norm = torch.sqrt(torch.sum(dx_p**2) + tail[0])
        cost_new = tail[1] + _unary(sb, new_poses, False, dp)
        return (new_poses, new_lms), chi2, cost_new, dx_norm

    return step


def gather_landmarks(sb: ShardedBA, lms: torch.Tensor) -> torch.Tensor:
    """Every rank's landmarks, (L, dl) in the graph's order, on every rank."""
    slab = sb.mesh.all_gather(lms, sb.lm_counts)
    return torch.empty_like(slab).index_copy_(0, torch.as_tensor(sb.lm_order, device=slab.device), slab)


def solve_schur_sharded(
    graph: FactorGraph,
    mesh: Mesh,
    options: _lm.Options = _lm.Options(),
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    partition: Partition | None = None,
    pcg_rtol: float = 1e-8,
    pcg_max_iters: int = 200,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 5,
    resume: bool = False,
):
    """Full landmark-sharded Schur LM solve.  Every rank passes the whole
    graph and gets back (solved_graph, final_chi2, cost_history), the
    solved values on the graph's device.

    Elastic recovery: with ``checkpoint_path`` set, rank 0 writes (poses,
    landmarks in the graph's order, lambda) every ``checkpoint_every``
    accepted iterations, as the reference's npz (keys ``poses``,
    ``landmarks``, ``lam``), then all ranks meet at a barrier;
    ``resume=True`` restarts every rank from the file.  The checkpoint does
    not depend on the mesh, so one written by n ranks resumes on any
    number, and one written by the JAX package resumes here."""
    sb = shard_ba(graph, mesh, pose_name, lm_name, partition)
    step = make_sharded_schur_step(sb, options, pcg_rtol, pcg_max_iters)

    # np.savez appends '.npz' where it is missing: one name for save and resume
    if checkpoint_path is not None and not checkpoint_path.endswith(".npz"):
        checkpoint_path = checkpoint_path + ".npz"
    state, opts = (sb.poses, sb.lms), options
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        dtype = sb.poses.dtype
        state = (torch.as_tensor(ck["poses"], dtype=dtype, device=mesh.device),
                 torch.as_tensor(ck["landmarks"][sb.lm_local], dtype=dtype, device=mesh.device))
        opts = dataclasses.replace(options, lambda_init=float(ck["lam"]))

    def on_accept(state, lam, n_accepted):
        if checkpoint_path is not None and n_accepted % checkpoint_every == 0:
            landmarks = gather_landmarks(sb, state[1])
            if mesh.rank == 0:
                np.savez(checkpoint_path.removesuffix(".npz"), poses=state[0].cpu().numpy(),
                         landmarks=landmarks.cpu().numpy(), lam=lam)
            mesh.barrier()

    (poses, lms), history, _info = host_lm_loop(step, state, opts, on_accept=on_accept)

    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    new_blocks = dict(graph.blocks)
    new_blocks[pose_name] = VariableBlock(pb.kind, poses.to(pb.values.device), pb.const_mask)
    new_blocks[lm_name] = VariableBlock(lb.kind, gather_landmarks(sb, lms).to(lb.values.device), lb.const_mask)
    solved = FactorGraph(new_blocks, graph.batches)
    return solved, float(solved.chi2()), history


def _gn_pieces(sb: ShardedBA):
    """The GN (undamped) reduced-system pieces at the rank's estimate, with
    the masks of ``make_sharded_schur_step``: (Hpp, replicated by one psum;
    Hll^-1 of the rank's landmarks; W of its observations; PP, replicated)."""
    mesh, C, dp, dl = sb.mesh, sb.C, sb.dp, sb.dl
    r, (Jc, Jl) = _observations(sb, sb.poses, sb.lms, True)
    w = sb.loss.weight(r) * sb.weight[:, None]
    wr = w * r
    cam = mesh.psum(sb.by_cam.sum(_rows(Jc, w, wr)))
    _, H_u, g_u, PP = _unary(sb, sb.poses, True, dp)
    lm = sb.by_lm.sum(_rows(Jl, w, wr))
    Hpp, _, Hll, _, W, PP = mask_constants(
        sb, cam[:, dp:].reshape(C, dp, dp) + H_u, -cam[:, :dp] - g_u, lm[:, dl:].reshape(lm.shape[0], dl, dl),
        -lm[:, :dl], _jtwj(Jc, w, Jl), PP, sb.free_p, sb.free_l)
    return Hpp, _binv(_cholesky(Hll)), W, PP


def _sharded_S_solver(sb: ShardedBA, pcg_rtol, pcg_max_iters, block):
    """(solve_rhs, Hll^-1, W): ``covariance``'s S-solves on the rank's
    pieces, every sum by camera followed by a psum; every rank solves the
    same replicated columns in the same blocks of ``block``."""
    Hpp, Hll_inv, W, PP = _gn_pieces(sb)

    def cam_sum(rows):
        return sb.mesh.psum(sb.by_cam.sum(rows))

    return _cov._S_pcg_solver(sb, Hpp, Hll_inv, W, PP, pcg_rtol, pcg_max_iters, cam_sum, block), Hll_inv, W


def sharded_pose_marginals(
    graph: FactorGraph,
    mesh: Mesh,
    indices=None,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    partition: Partition | None = None,
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
    chunk: int = 64,
):
    """(k, dp, dp) pose marginal covariances of a landmark-sharded camera /
    landmark graph (all poses where ``indices`` is None), on every rank:
    Sigma_pp = S^-1, each block of ``chunk`` requested tangent columns (a
    multiple of dp) one PCG solve whose product is rank-local work plus one
    psum.  Landmark elimination stays on the ranks; no rank forms the
    landmark side of H.  Constant poses return unit blocks, as
    ``pose_marginal_covariances``."""
    sb = shard_ba(graph, mesh, pose_name, lm_name, partition)
    C, dp = sb.C, sb.dp
    block = max(dp, chunk - chunk % dp)
    solve_rhs, _, W = _sharded_S_solver(sb, pcg_rtol, pcg_max_iters, block)
    if indices is None:
        indices = np.arange(C)
    return _cov._diag_blocks(solve_rhs, indices, C, dp, block, W.dtype, mesh.device)


def sharded_landmark_marginals(
    graph: FactorGraph,
    mesh: Mesh,
    indices,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    partition: Partition | None = None,
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
):
    """(k, dl, dl) landmark marginal covariances of a landmark-sharded graph,
    on every rank, by Sigma_ll,ii = (Hll^-1)_ii + B_i^T S^-1 B_i: B_i and
    (Hll^-1)_ii are built on the landmark's owner rank (its observations
    live there) and replicated by one psum, then the k dl columns are
    S-solved in blocks of 64 // dl whole landmarks (``sharded_pose_marginals``'
    default chunk of 64 columns).  An unobserved landmark returns its masked
    unit block."""
    sb = shard_ba(graph, mesh, pose_name, lm_name, partition)
    C, dp, dl = sb.C, sb.dp, sb.dl
    block = dl * max(1, 64 // dl)
    solve_rhs, Hll_inv, W = _sharded_S_solver(sb, pcg_rtol, pcg_max_iters, block)
    indices = np.asarray(indices, np.int64).reshape(-1)
    k = len(indices)
    local_row = {int(g): r for r, g in enumerate(sb.lm_local)}
    mine = [j for j, i in enumerate(indices) if int(i) in local_row]
    aux = dict(C=C, dp=dp, Hll_inv=Hll_inv, W=W, ci=sb.cam_idx.cpu().numpy(), li=sb.pt_idx.cpu().numpy())
    B_mine, H_mine, _ = _cov._landmark_B(aux, [local_row[int(indices[j])] for j in mine])
    # (k, C dp + dl, dl): each requested landmark's B_i over its (Hll^-1)_ii,
    # filled by its owner, zero elsewhere, summed over the ranks
    buf = W.new_zeros((k, C * dp + dl, dl))
    if mine:
        at = torch.as_tensor(mine, device=W.device)
        buf[at, :C * dp] = B_mine.reshape(C * dp, len(mine), dl).transpose(0, 1)
        buf[at, C * dp:] = H_mine
    buf = mesh.psum(buf)
    Bk, Hi = buf[:, :C * dp], buf[:, C * dp:]
    X = solve_rhs(Bk.transpose(0, 1).reshape(C * dp, k * dl))
    Xk = X.reshape(C * dp, k, dl).transpose(0, 1)
    return _cov._symmetrize(Hi + Bk.transpose(-1, -2) @ Xk)


__all__ = ["ShardedBA", "shard_ba", "make_sharded_schur_step", "solve_schur_sharded", "gather_landmarks",
           "sharded_pose_marginals", "sharded_landmark_marginals"]
