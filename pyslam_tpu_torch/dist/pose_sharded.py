"""Variable-sharded pose-graph solving (the tensor-parallel analogue).

Counterpart of ``pyslam_tpu/dist/pose_sharded.py`` (``ShardedPoseGraph``,
``shard_pose_graph``, ``_pcg_dist``, ``make_pose_sharded_step``,
``solve_pose_sharded``, with its checkpoints).  Layout:

* The poses are partitioned over the ranks (``partition_poses_bfs`` by
  default: contiguous low-cut segments on trajectory-like graphs) and
  numbered rank after rank, so rank r owns the rows [start_r, start_r +
  Pr) of one global numbering.  The pose state is small, so each
  linearization and each cost takes one ``mesh.all_gather`` of it.
* A factor is copied onto every rank that owns one of its poses.  Each
  copy contributes only the Hessian blocks and gradient rows of the poses
  its rank owns, so assembly needs no collective beyond that gather.  The
  sums into the rank's diagonal-at-slot-0 symmetric ELL store and its
  gradient rows are ``slot_reduce`` over plans built once in
  ``shard_pose_graph``; a copy's blocks that belong to another rank go to
  one extra destination, which is dropped.
* The linear solve is PCG over the ranks: the local product is the ELL
  product of the rank's rows against the x of every rank, gathered, which
  is the ``ell_matvec`` kernel (its x longer than the rank's rows); the
  dot products are summed with ``mesh.psum``; the stop test is applied on
  the device and never read (``schur_large._pcg``).

chi2 counts each factor once: only the copy on the owner of its first
pose adds its cost.  A rank holds its own sizes; only the gathers pad,
inside ``mesh.all_gather``.  The LM loop is the shared host loop, one host
read an LM iteration of all-reduced values.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..graph.core import FACTOR_KERNELS, FactorGraph, VariableBlock, retract
from ..solver import lm as _lm
from ..solver.bcsr import sym_block_inv
from ..solver.cuda_ops import ell_matvec
from ..solver.host_loop import host_lm_loop
from ..solver.schur import Segments, _jtwj, _mv, _tmv
from ..solver.schur_large import _CG_ITERATIONS, _pcg, _segments
from .mesh import Mesh
from .partitioner import Partition, partition_poses_bfs


@dataclasses.dataclass(frozen=True)
class LocalBatch:
    """The copies of one factor batch on a rank."""

    kind: str
    loss: object
    n_slots: int
    data: dict  # the copies' data; values without the factor axis as given
    sidx: tuple  # per slot, (F,) int64 global numbers of the copies' poses
    weight: torch.Tensor  # (F,)
    wc: torch.Tensor  # (F,) weight of the copies that count the cost, else 0


@dataclasses.dataclass
class ShardedPoseGraph:
    """One rank's plan of a single-block graph, on ``mesh.device``."""

    mesh: Mesh
    block_name: str
    kind: str  # the manifold
    nb: int  # poses of the whole graph
    d: int  # tangent dof
    K: int  # ELL row width (1 + the largest neighbour count)
    counts: tuple  # poses of each rank
    slot_of: np.ndarray  # (nb,) pose -> global number
    local: np.ndarray  # (Pr,) this rank's poses
    pose_slab: torch.Tensor  # (Pr, ...) their values
    free: torch.Tensor  # (Pr,) 1.0 where free
    free_cols: torch.Tensor  # (Pr, K) the same of each row's columns
    cols: torch.Tensor  # (Pr, K) int32 global numbers
    batches: tuple  # LocalBatch
    h_seg: Segments  # every Hessian contribution to its ELL slot, or to Pr*K (dropped)
    g_seg: Segments  # every gradient contribution to its row, or to Pr (dropped)


def _bfs_partition(graph, nb, n):
    """``partition_poses_bfs`` over the union of every pair of distinct
    poses a factor links."""
    eis, ejs = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for fb in graph.batches:
        idx = [i.detach().cpu().numpy().astype(np.int64) for i in fb.indices]
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                m = idx[a] != idx[b]
                eis.append(idx[a][m])
                ejs.append(idx[b][m])
    return partition_poses_bfs(np.concatenate(eis), np.concatenate(ejs), nb, n)


def shard_pose_graph(graph: FactorGraph, mesh: Mesh, partition: Partition | None = None) -> ShardedPoseGraph:
    """This rank's plan of a single-block factor graph, built on the host,
    the same on every rank; only the rank's share goes to
    ``mesh.device``."""
    n, rank, device = mesh.size, mesh.rank, mesh.device
    if len(graph.blocks) != 1:
        raise ValueError(f"shard_pose_graph takes a graph of one variable block, not {len(graph.blocks)}")
    ((name, blk),) = graph.blocks.items()
    nb, d = blk.n, blk.dof
    if partition is None:
        partition = _bfs_partition(graph, nb, n)
    part = np.asarray(partition.part, np.int64)
    if len(part) != nb or partition.n_parts != n or (nb and (part.min() < 0 or part.max() >= n)):
        raise ValueError(f"shard_pose_graph: a partition of {nb} poses into {n} parts expected")
    order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=n)
    start = int(np.concatenate([[0], np.cumsum(counts)])[rank])
    Pr = int(counts[rank])
    slot_of = np.empty(nb, np.int64)
    slot_of[order] = np.arange(nb)
    local = order[start:start + Pr]

    # ---- the symmetric ELL structure on the global numbers (diagonal at slot 0)
    batch_sidx = []
    us, vs = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for fb in graph.batches:
        idx = []
        for i in fb.indices:
            i = i.detach().cpu().numpy().astype(np.int64)
            if len(i) and (i.min() < 0 or i.max() >= nb):
                raise ValueError(f"factor batch {fb.kind!r}: index out of range [0, {nb})")
            idx.append(i)
        sidx = [slot_of[i] for i in idx]
        batch_sidx.append((idx, sidx))
        for a in range(len(sidx)):
            for b in range(a + 1, len(sidx)):
                m = sidx[a] != sidx[b]
                us += [sidx[a][m], sidx[b][m]]
                vs += [sidx[b][m], sidx[a][m]]
    keys = np.unique(np.concatenate(us) * nb + np.concatenate(vs))
    eu, ev = keys // nb, keys % nb
    row_counts = np.bincount(eu, minlength=nb)
    K = 1 + (int(row_counts.max()) if len(keys) else 0)
    erank = np.arange(len(keys)) - np.concatenate([[0], np.cumsum(row_counts)[:-1]])[eu]
    cols = np.tile(np.arange(nb, dtype=np.int64)[:, None], (1, K))
    cols[eu, 1 + erank] = ev
    cols = cols[start:start + Pr]  # every entry in [0, nb): the range ell_matvec reads

    def ell_slot(uu, vv):
        """The flat position of block (uu, vv) in the rank's ELL store."""
        if len(keys) == 0:  # a graph of unary factors: every block is diagonal
            slot = np.zeros(np.shape(uu), np.int64)
        else:
            pos = np.minimum(np.searchsorted(keys, uu * nb + vv), len(keys) - 1)
            slot = np.where(uu == vv, 0, 1 + erank[pos])
        return (uu - start) * K + slot

    # ---- the factor copies of this rank
    dtype = blk.values.dtype
    batches, h_dest, g_dest = [], [], []
    for fb, (idx, sidx) in zip(graph.batches, batch_sidx):
        S = len(sidx)
        own = [part[i] == rank for i in idx]  # this rank owns the slot's pose
        lf = np.flatnonzero(np.logical_or.reduce(own)) if S else np.zeros(0, np.int64)
        own = [o[lf] for o in own]
        sl = [s[lf] for s in sidx]
        for s in range(S):
            g_dest.append(np.where(own[s], sl[s] - start, Pr))
        for a in range(S):
            for b in range(a, S):
                h_dest.append(np.where(own[a], ell_slot(sl[a], sl[b]), Pr * K))
                if a != b:
                    h_dest.append(np.where(own[b], ell_slot(sl[b], sl[a]), Pr * K))
        lf_t = torch.as_tensor(lf, device=fb.weight.device)  # a graph's tensors share one device

        def take(v):
            return v[lf_t].to(device)

        weight = take(fb.weight)
        batches.append(LocalBatch(
            kind=fb.kind, loss=fb.loss, n_slots=S,
            data={k: (take(v) if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == fb.n
                      else (v.to(device) if torch.is_tensor(v) else v)) for k, v in fb.data.items()},
            sidx=tuple(torch.as_tensor(s, device=device) for s in sl), weight=weight,
            wc=weight * torch.as_tensor(own[0], device=device).to(weight.dtype)))

    def cat(arrays):
        return np.concatenate(arrays) if arrays else np.zeros(0, np.int64)

    free_all = (~blk.const_mask).detach().cpu().numpy()[order]
    local_t = torch.as_tensor(local, device=blk.values.device)
    return ShardedPoseGraph(
        mesh=mesh, block_name=name, kind=blk.kind, nb=nb, d=d, K=K, counts=tuple(int(c) for c in counts),
        slot_of=slot_of, local=local, pose_slab=blk.values[local_t].to(device),
        free=torch.as_tensor(free_all[start:start + Pr], device=device).to(dtype),
        free_cols=torch.as_tensor(free_all[cols], device=device).to(dtype),
        cols=torch.as_tensor(cols.astype(np.int32), device=device),
        batches=tuple(batches), h_seg=_segments(cat(h_dest), Pr * K + 1, device),
        g_seg=_segments(cat(g_dest), Pr + 1, device),
    )


def _evaluate(b: LocalBatch, poses_full, want_grad):
    return FACTOR_KERNELS[b.kind](b.data, *(poses_full[s] for s in b.sidx), compute_jacobians=want_grad)


def _contributions(sp: ShardedPoseGraph, poses_full):
    """The rank's share of the normal equations at ``poses_full`` (every
    pose, in the global numbering), before the sums: (chi2 of the copies
    that count the cost, the Hessian rows that ``h_seg`` sums (·, d²), the
    gradient rows that ``g_seg`` sums (·, d))."""
    d = sp.d
    chi2 = poses_full.new_zeros(())
    h_parts, g_parts = [], []
    for b in sp.batches:
        r, jacs = _evaluate(b, poses_full, True)
        w = b.loss.weight(r) * b.weight[:, None]
        chi2 = chi2 + torch.sum(b.loss.loss(r) * b.wc[:, None])
        g_parts += [_tmv(J, w * r) for J in jacs]
        for a in range(b.n_slots):
            for c in range(a, b.n_slots):
                C = _jtwj(jacs[a], w, jacs[c])
                h_parts.append(C.reshape(-1, d * d))
                if a != c:
                    h_parts.append(C.transpose(-1, -2).reshape(-1, d * d))
    return chi2, torch.cat(h_parts), torch.cat(g_parts)


def make_pose_sharded_step(sp: ShardedPoseGraph, options: _lm.Options, pcg_rtol: float = 1e-8,
                           pcg_max_iters: int = 250):
    """One variable-sharded LM iteration.

    ``step(pose_slab, lam) -> (new_pose_slab, chi2, cost_new, dx_norm)``,
    the costs and the update norm summed over the ranks.  Collectives: a
    gather of the poses for the linearization and one for the trial cost,
    one ``psum`` for the costs and the update norm; a CG iteration gathers
    x and sums its dot products twice."""
    mesh, Pr, K, d = sp.mesh, sp.pose_slab.shape[0], sp.K, sp.d
    x_counts = [c * d for c in sp.counts]
    fr = sp.free

    def cost(poses_full):
        total = poses_full.new_zeros(())
        for b in sp.batches:
            r, _ = _evaluate(b, poses_full, False)
            total = total + torch.sum(b.loss.loss(r) * b.wc[:, None])
        return total

    def step(slab, lam):
        chi2, h_rows, g_rows = _contributions(sp, mesh.all_gather(slab, sp.counts))
        He = sp.h_seg.sum(h_rows)[: Pr * K].reshape(Pr, K, d, d)
        g = -sp.g_seg.sum(g_rows)[:Pr]
        del h_rows, g_rows

        # constant dofs: zero rows and columns, unit diagonal; a live row
        # without factors: unit diagonal, so the preconditioner stays SPD
        eye = torch.eye(d, dtype=He.dtype, device=He.device)
        He = He * fr[:, None, None, None] * sp.free_cols[:, :, None, None]
        He[:, 0] += (1.0 - fr)[:, None, None] * eye
        g = (g * fr[:, None]).reshape(-1)
        dead = (torch.diagonal(He[:, 0], dim1=-2, dim2=-1).sum(-1) == 0.0).to(He.dtype)
        He[:, 0] += dead[:, None, None] * eye

        D = He[:, 0]
        if options.method == "lm":
            D = D + lam * torch.diag_embed(torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=1e-12))
            He[:, 0] = D
        Minv = sym_block_inv(D)

        def matvec(x):
            return ell_matvec(He, sp.cols, mesh.all_gather(x, x_counts))

        def precond(r):
            return _mv(Minv, r.reshape(Pr, d)).reshape(-1)

        x, it = _pcg(matvec, precond, g, pcg_rtol, pcg_max_iters, psum=mesh.psum)
        _CG_ITERATIONS.append(it)
        dx = x.reshape(Pr, d) * fr[:, None]
        new_slab = retract(sp.kind, slab, dx)
        tail = mesh.psum(torch.stack([chi2, torch.sum(dx**2), cost(mesh.all_gather(new_slab, sp.counts))]))
        return new_slab, tail[0], tail[2], torch.sqrt(tail[1])

    return step


def gather_poses(sp: ShardedPoseGraph, slab: torch.Tensor) -> torch.Tensor:
    """Every rank's poses, (nb, ...) in the graph's order, on every rank."""
    full = sp.mesh.all_gather(slab, sp.counts)
    return full[torch.as_tensor(sp.slot_of, device=full.device)]


def solve_pose_sharded(
    graph: FactorGraph,
    mesh: Mesh,
    options: _lm.Options = _lm.Options(),
    partition: Partition | None = None,
    pcg_rtol: float = 1e-8,
    pcg_max_iters: int = 250,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 5,
    resume: bool = False,
):
    """Full variable-sharded pose-graph LM solve.  Every rank passes the
    whole graph and gets back (solved_graph, final_chi2, cost_history),
    the solved values on the graph's device.

    Elastic recovery, as in ``schur_reduce``: with ``checkpoint_path`` set,
    rank 0 writes the values in the graph's pose order and lambda (npz keys
    ``values``, ``lam``) every ``checkpoint_every`` accepted iterations,
    then all ranks meet at a barrier; ``resume=True`` restarts every rank
    from the file, whatever the number of ranks that wrote it."""
    sp = shard_pose_graph(graph, mesh, partition)
    step = make_pose_sharded_step(sp, options, pcg_rtol, pcg_max_iters)
    if checkpoint_path is not None and not checkpoint_path.endswith(".npz"):
        checkpoint_path = checkpoint_path + ".npz"
    slab0, opts = sp.pose_slab, options
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        slab0 = torch.as_tensor(ck["values"][sp.local], dtype=slab0.dtype, device=mesh.device)
        opts = dataclasses.replace(options, lambda_init=float(ck["lam"]))

    def on_accept(state, lam, n_accepted):
        if checkpoint_path is not None and n_accepted % checkpoint_every == 0:
            values = gather_poses(sp, state)
            if mesh.rank == 0:
                np.savez(checkpoint_path.removesuffix(".npz"), values=values.cpu().numpy(), lam=lam)
            mesh.barrier()

    slab, history, _info = host_lm_loop(step, slab0, opts, on_accept=on_accept)
    blk = graph.blocks[sp.block_name]
    values = gather_poses(sp, slab).to(blk.values.device)
    solved = FactorGraph({sp.block_name: VariableBlock(blk.kind, values, blk.const_mask)}, graph.batches)
    return solved, float(solved.chi2()), history


__all__ = ["ShardedPoseGraph", "shard_pose_graph", "make_pose_sharded_step", "solve_pose_sharded", "gather_poses"]
