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
from ..solver import lm as _lm
from ..solver.host_loop import host_lm_loop
from ..solver.schur import Segments, _back_substitute, _jtwj, _tmv, mask_constants
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
    n, rank, device = mesh.size, mesh.rank, mesh.device
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    C, dp, L, dl = pb.n, pb.dof, lb.n, lb.dof
    obs = [fb for fb in graph.batches if tuple(fb.slots) in ((pose_name, lm_name), (lm_name, pose_name))]
    rep = [fb for fb in graph.batches if tuple(fb.slots) in ((pose_name,), (pose_name, pose_name))]
    if len(obs) != 1 or len(obs) + len(rep) != len(graph.batches):
        raise ValueError("shard_ba supports exactly one pose-landmark batch plus pose-unary and pose-pose batches")
    (fb,) = obs
    pose_first = tuple(fb.slots) == (pose_name, lm_name)

    if partition is None:
        partition = partition_landmarks(None, None, L, n_parts=n)
    part = np.asarray(partition.part, np.int64)
    if len(part) != L or partition.n_parts != n or (L and (part.min() < 0 or part.max() >= n)):
        raise ValueError(f"shard_ba: a partition of {L} landmarks into {n} parts expected")
    lm_order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    local_row = np.empty(L, np.int64)  # a landmark's row in its owner's slab
    local_row[lm_order] = np.arange(L) - starts[part[lm_order]]
    lm_local = lm_order[starts[rank]:starts[rank] + counts[rank]]

    cam_t, pt_t = fb.indices if pose_first else fb.indices[::-1]
    cam = _host_index(cam_t, C, f"factor batch {fb.kind!r} slot {pose_name!r}")
    pt = _host_index(pt_t, L, f"factor batch {fb.kind!r} slot {lm_name!r}")
    mine = np.flatnonzero(part[pt] == rank)  # this rank's observations, in graph order
    cam_l, pt_l = cam[mine], local_row[pt[mine]]
    M = fb.n

    def take(v, ids):
        return v[torch.as_tensor(ids, device=v.device)].to(device)

    obs_data = {k: (take(v, mine) if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == M
                    else (v.to(device) if torch.is_tensor(v) else v)) for k, v in fb.data.items()}

    u_dest, pis, pjs = [], [], []
    for u in rep:
        idx = [_host_index(i, C, f"factor batch {u.kind!r} slot {pose_name!r}") for i in u.indices]
        u_dest += idx
        if len(idx) == 2:
            pis.append(idx[0])
            pjs.append(idx[1])

    def cat(arrays):
        return np.concatenate(arrays) if arrays else np.zeros(0, np.int64)

    pi, pj = cat(pis), cat(pjs)
    dtype = pb.values.dtype
    return ShardedBA(
        mesh=mesh, kind=fb.kind, pose_kind=pb.kind, pose_first=pose_first, loss=fb.loss, C=C, L=L, dp=dp, dl=dl,
        lm_counts=tuple(int(c) for c in counts), lm_order=lm_order, lm_local=lm_local,
        poses=pb.values.to(device), free_p=(~pb.const_mask).to(device, dtype),
        lms=take(lb.values, lm_local), free_l=take(~lb.const_mask, lm_local).to(dtype),
        obs_data=obs_data, weight=take(fb.weight, mine),
        cam_idx=torch.as_tensor(cam_l, device=device), pt_idx=torch.as_tensor(pt_l, device=device),
        by_cam=_segments(cam_l, C, device), by_lm=_segments(pt_l, len(lm_local), device),
        unary=tuple(_batch_to(u, device) for u in rep), by_pose_u=_segments(cat(u_dest), C, device),
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


__all__ = ["ShardedBA", "shard_ba", "make_sharded_schur_step", "solve_schur_sharded", "gather_landmarks"]
