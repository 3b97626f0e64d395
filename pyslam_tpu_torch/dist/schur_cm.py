"""Component-major landmark-sharded Schur BA: the multi-device form of
``solver/schur_large.py`` (bench config 5 at full Venice scale).

Counterpart of ``pyslam_tpu/dist/schur_cm.py`` (``ShardedCM``,
``shard_ba_cm``, ``make_cm_step``, ``solve_schur_cm``).  The reference
joins two layouts measured at scale on a TPU: per-observation data stored
component-major (flat vectors, no tile padding) and the landmark sharding
of ``dist/schur_reduce.py``, with every sum by camera a cumsum and a
boundary difference over a rank's camera-sorted observations.  The
capability it carries is ``solve_schur_large``'s per-rank machinery under
the collectives of ``dist/``, and that is what this module is:

  * the partition, the landmark shares and the replicated pose-unary and
    (pose, pose) batches are ``schur_reduce.shard_ba``'s: landmarks split
    over the ranks, their observations on the owner rank, cameras
    replicated, each rank holding its own sizes (no padding with safe
    points, which ``shard_map`` needs and ``torch.distributed`` does not);
  * a rank's share is a ``schur_large.LargeBA`` plan of its own
    observations: sorted stably by camera once, linearized into
    full-length row buffers (monocular BAL observations by one
    ``cuda_ops.bal_rows`` launch, other kinds over ``n_chunks`` chunks, so
    that no (Mr, m, dof) Jacobian of the whole share exists at once), every
    sum by camera and by landmark ``cuda_ops.slot_reduce`` over the plan's
    ``Segments``;
  * the Schur algebra and PCG are ``schur_large._solve_pcg`` with a
    ``cam_sum`` that follows every sum by camera with a ``mesh.psum``.

Collectives per LM iteration: one ``psum`` of the cost, the camera
gradient and the camera Hessian blocks; one of the reduced gradient; one
of the block diagonal D of S; one per CG iteration (the loop never reads
its stop test, ``schur_large.CG_READ_EVERY``, so it runs ``pcg_max_iters``
products); one of the update norm and the trial cost: 4 + pcg_max_iters
``psum`` in all.  The result (and every checkpoint) gathers the landmarks
once.  The LM loop is the shared ``host_lm_loop``, one host read an LM
iteration, of all-reduced values, so every rank takes the same branch.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..graph.core import FactorGraph, VariableBlock, retract
from ..solver import lm as _lm
from ..solver.host_loop import host_lm_loop
from ..solver.schur import _back_substitute
from ..solver.schur_large import LargeBA, _obs_cost, _obs_rows, _parts, _solve_pcg, _unary, prepare_large_ba
from .mesh import Mesh
from .partitioner import Partition
from .schur_reduce import _batch_to, gather_landmarks, rank_batch, split_ba


@dataclasses.dataclass
class ShardedCM:
    """One rank's share of a camera / landmark graph, on ``mesh.device``:
    ``plan`` is the ``LargeBA`` of the rank's landmarks (``L`` its count)
    and their observations in camera order, with the replicated poses and
    pose-unary / (pose, pose) batches."""

    mesh: Mesh
    C: int
    L: int  # landmarks of the whole graph
    lm_counts: tuple  # landmarks of each rank
    lm_order: np.ndarray  # (L,) the landmarks, rank after rank
    lm_local: np.ndarray  # (Lr,) this rank's landmarks, in graph order
    plan: LargeBA

    @property
    def poses(self):
        return self.plan.poses

    @property
    def lms(self):
        return self.plan.lms


def shard_ba_cm(
    graph: FactorGraph,
    mesh: Mesh,
    n_chunks: int = 8,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    partition: Partition | None = None,
) -> ShardedCM:
    """This rank's share of a BA graph of ``se3`` poses and 3-dof landmarks:
    one observation batch (either slot order) plus pose-unary and (pose,
    pose) batches; anything else raises ValueError before any plan is
    built.  The host plan is the same on every rank; only the rank's share
    goes to ``mesh.device``."""
    device = mesh.device
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    if pb.kind != "se3" or lb.dof != 3:
        raise ValueError(
            f"{pose_name}/{lm_name} must be se3 poses + 3-dof landmarks "
            f"(got {pb.kind!r} / {lb.dof}-dof); use solve_schur / "
            "solve_auto for other manifolds"
        )
    fb, rep, _, pose_first, lm_order, counts, lm_local, mine, idx = split_ba(
        graph, mesh, pose_name, lm_name, partition, "schur_cm")

    at = torch.as_tensor(lm_local, device=lb.values.device)
    blocks = {
        pose_name: VariableBlock(pb.kind, pb.values.to(device), pb.const_mask.to(device)),
        lm_name: VariableBlock(lb.kind, lb.values[at].to(device), lb.const_mask[at].to(device)),
    }
    batches = [rank_batch(fb, mine, idx if pose_first else idx[::-1], device)]
    batches += [_batch_to(u, device) for u in rep]
    plan = prepare_large_ba(FactorGraph(blocks, batches), n_chunks, pose_name, lm_name)
    return ShardedCM(mesh=mesh, C=pb.n, L=lb.n, lm_counts=tuple(int(c) for c in counts),
                     lm_order=lm_order, lm_local=lm_local, plan=plan)


def make_cm_step(sb: ShardedCM, options: _lm.Options, pcg_rtol=1e-4, pcg_max_iters=30):
    """One sharded component-major Schur LM iteration.

    ``step((poses, lms), lam) -> ((new_poses, new_lms), chi2, cost_new,
    dx_norm)``: ``lms`` the rank's landmarks, the costs and the update norm
    summed over the ranks.  Collectives: 4 + ``pcg_max_iters`` ``psum``
    (the module's docstring)."""
    mesh, plan, C = sb.mesh, sb.plan, sb.C

    def cam_sum(rows):
        return mesh.psum(plan.by_cam.sum(rows))

    def step(state, lam):
        poses, lms = state
        cost, rows = _obs_rows(plan, poses, lms)
        red = mesh.psum(torch.cat([cost.sum().reshape(1), plan.by_cam.sum(rows[:, :27]).reshape(-1)]))
        c_u, parts = _parts(plan, poses, red[1:].reshape(C, 27), plan.by_lm.sum(rows[:, 27:36]), rows)
        chi2 = red[0] + c_u
        del cost, rows
        Hll_inv, x = _solve_pcg(parts, lam, options.method, pcg_rtol, pcg_max_iters, cam_sum)
        dx_p = x.reshape(C, 6) * plan.free_p[:, None]
        dx_l = _back_substitute(Hll_inv, parts["W"], plan, parts["g_l"], dx_p)
        del parts, Hll_inv

        new_poses = retract("se3", poses, dx_p)
        new_lms = lms + dx_l
        tail = mesh.psum(torch.stack([torch.sum(dx_l**2), _obs_cost(plan, new_poses, new_lms)]))
        dx_norm = torch.sqrt(torch.sum(dx_p**2) + tail[0])
        cost_new = tail[1] + _unary(plan, new_poses, False)
        return (new_poses, new_lms), chi2, cost_new, dx_norm

    return step


def solve_schur_cm(
    graph: FactorGraph,
    mesh: Mesh,
    options: _lm.Options = _lm.Options(),
    n_chunks: int = 8,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    partition: Partition | None = None,
    pcg_rtol: float = 1e-4,
    pcg_max_iters: int = 30,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 5,
    resume: bool = False,
):
    """Sharded component-major Schur LM solve.  Every rank passes the whole
    graph and gets back (solved_graph, final_chi2, cost_history): the last
    accepted cost and the accepted costs as Python floats, the solved
    values on the graph's device.

    Elastic recovery, the contract of ``solve_schur_sharded``: with
    ``checkpoint_path`` set, rank 0 writes (poses, landmarks in the graph's
    order, lambda) every ``checkpoint_every`` accepted iterations as the
    reference's npz (keys ``poses``, ``landmarks``, ``lam``), then all ranks
    meet at a barrier; ``resume=True`` restarts every rank from the file,
    which does not depend on the mesh: one written by n ranks resumes on
    any number, and one written by the JAX package resumes here."""
    sb = shard_ba_cm(graph, mesh, n_chunks, pose_name, lm_name, partition)
    step = make_cm_step(sb, options, pcg_rtol, pcg_max_iters)

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
    return FactorGraph(new_blocks, graph.batches), history[-1], history


__all__ = ["ShardedCM", "shard_ba_cm", "make_cm_step", "solve_schur_cm"]
