"""Factor-parallel sharded solving (the data-parallel analogue).

Counterpart of ``pyslam_tpu/dist/factor_parallel.py`` (``pad_batch``,
``shard_graph``, ``make_sharded_lm_step``, ``solve_factor_parallel``).
Every batch's factors are split over the ranks; each rank assembles the
dense normal equations of its share with ``assemble_dense`` (whose sums
are ``slot_reduce``), H, g and chi2 are summed with ``mesh.psum``, and the
damped Cholesky solve and the retraction run replicated on every rank.
Variable blocks are replicated.  The LM loop is the shared host loop,
with one host read an iteration of values that are the same on every
rank, so every rank takes the same branch.
"""

from __future__ import annotations

import torch

from ..graph.core import FactorBatch, FactorGraph, VariableBlock
from ..solver import lm as _lm
from ..solver.assemble import assemble_dense, dense_plan, unit_diag_where_dead_
from ..solver.host_loop import host_lm_loop
from ..solver.linear import cholesky_solve, damp_marquardt_
from .mesh import Mesh


def _factor_axis(v, n):
    return torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == n


def pad_batch(fb: FactorBatch, multiple: int) -> FactorBatch:
    """Pad a factor batch to a multiple of ``multiple`` factors with
    zero-weight (inert) copies of its first factor."""
    n = fb.n
    pad = (-n) % multiple
    if pad == 0:
        return fb
    idx = tuple(torch.cat([i, i.new_zeros(pad)]) for i in fb.indices)
    data = {k: (torch.cat([v, v[:1].expand((pad,) + v.shape[1:])]) if _factor_axis(v, n) else v)
            for k, v in fb.data.items()}
    weight = torch.cat([fb.weight, fb.weight.new_zeros(pad)])
    return FactorBatch(fb.kind, fb.slots, idx, data, fb.loss, weight)


def _to(v, device):
    return v.to(device) if torch.is_tensor(v) else v


def shard_graph(graph: FactorGraph, mesh: Mesh) -> FactorGraph:
    """This rank's graph on ``mesh.device``: every variable block, and of
    every batch, padded to a multiple of the mesh size, the rank's
    contiguous share."""
    n, r = mesh.size, mesh.rank
    blocks = {name: VariableBlock(b.kind, b.values.to(mesh.device), b.const_mask.to(mesh.device))
              for name, b in graph.blocks.items()}
    batches = []
    for fb in graph.batches:
        p = pad_batch(fb, n)
        share = p.n // n
        lo, hi = r * share, (r + 1) * share
        batches.append(FactorBatch(
            p.kind, p.slots, tuple(_to(i[lo:hi], mesh.device) for i in p.indices),
            {k: _to(v[lo:hi] if _factor_axis(v, p.n) else v, mesh.device) for k, v in p.data.items()},
            p.loss, p.weight[lo:hi].to(mesh.device)))
    return FactorGraph(blocks, batches)


def make_sharded_lm_step(graph: FactorGraph, mesh: Mesh, options: _lm.Options):
    """(step, local graph): one factor-parallel LM iteration.

    ``step(blocks, lam) -> (new_blocks, chi2, cost_new, dx_norm)``, the
    costs summed over the ranks, the step replicated."""
    local = shard_graph(graph, mesh)
    plan = dense_plan(local)
    D = plan.D

    def step(blocks, lam):
        g_local = local.with_values(blocks)
        H, g, chi2 = assemble_dense(g_local, plan)
        mesh.psum(H)
        gc = mesh.psum(torch.cat([g, chi2.reshape(1)]))
        g, chi2 = gc[:D], gc[D]
        # assemble_dense gives a frozen dof its unit diagonal on every rank,
        # so the sum makes it n_dev, as in the reference: still SPD, and the
        # step there is 0.  Dead dofs are fixed after the sum: a dof dead on
        # one rank may be live on another.
        unit_diag_where_dead_(H)
        if options.method == "lm":
            damp_marquardt_(H, lam)
        dx = cholesky_solve(H, g)
        new = g_local.retract_all(dx)
        cost_new = mesh.psum(new.chi2().reshape(1))[0]
        return new.blocks, chi2, cost_new, torch.linalg.norm(dx)

    return step, local


def solve_factor_parallel(graph: FactorGraph, mesh: Mesh, options: _lm.Options = _lm.Options()):
    """Full LM solve with factor-parallel iterations over the shared host
    loop.  Every rank passes the whole graph and gets back (solved_graph,
    final_chi2, cost_history); the solved values are on the graph's
    device."""
    step, local = make_sharded_lm_step(graph, mesh, options)
    best, history, _info = host_lm_loop(step, dict(local.blocks), options)
    solved = graph.with_values({
        name: VariableBlock(b.kind, best[name].values.to(b.values.device), b.const_mask)
        for name, b in graph.blocks.items()})
    return solved, float(solved.chi2()), history


__all__ = ["pad_batch", "shard_graph", "make_sharded_lm_step", "solve_factor_parallel"]
