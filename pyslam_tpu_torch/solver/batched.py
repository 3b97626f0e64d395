"""A fleet of same-structure graphs in one LM loop: ``solve_batched``.

Counterpart of ``solve_batched`` in ``pyslam_tpu/solver/__init__.py``,
which is ``jax.vmap`` over ``solve``.  ``lm.solve`` here is a host loop that
a vmap cannot trace, so the fleet runs as one batched dense LM:

  * the B graphs become one graph of B disjoint copies (``_union``): every
    block holds the B problems' variables one problem after the other, and
    every batch their factors, so one linearization pass evaluates all B·F
    factors;
  * one plan (``_batched_plan``) sums the contributions of all problems
    into a (B, D, D) stack of Hessians and a (B, D) gradient through
    ``slot_reduce``; one batched ``cholesky_ex`` solves the B systems (a
    failed factorization gives that problem a NaN step);
  * every problem keeps its own λ, best point, counters and stop code,
    updated on the device by the accept and stop rules of ``lm.solve``.  A
    problem that has stopped keeps its state, as a problem whose
    ``while_loop`` has ended does under ``vmap``.  The host reads the B stop
    codes as one tensor once an iteration (``HOST_READS["lm"]``) and loops
    until every problem has stopped.

Each problem follows the accept sequence and the stop code of its own
``lm.solve``, in every method: 'lm' and 'gn', and 'dogleg' with each
problem's own trust radius, step blend and gain-ratio test (``lm``'s dogleg
functions vmapped over the problems).  A ``TDistributionLoss(scale=None)``
estimates its scale per problem, over each problem's own residuals, as the
reference's vmap of ``solve`` does: a problem's factors are a contiguous
block of every union batch, so the loss is vmapped over the rows of a
(B, n r) view, on the device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..graph.core import FactorBatch, FactorGraph, VariableBlock
from ..losses import TDistributionLoss
from ..observability import span
from . import lm as _lm
from .assemble import _group, _reduce_into, dense_contributions, free_mask, structure_key
from .linear import HOST_READS, cholesky_solve
from .plan_cache import ClosureCache


class BatchedSolveInfo(NamedTuple):
    """Per-problem counterpart of ``lm.SolveInfo``: every field has the
    problem axis first."""

    chi2: torch.Tensor  # (B,) best cost reached
    iterations: list  # B ints
    status: list  # B stop codes (lm.STATUS_NAMES)
    cost_history: torch.Tensor  # (B, max_iters + 1), NaN-padded
    lambda_history: torch.Tensor  # (B, max_iters), NaN-padded
    update_norms: torch.Tensor  # (B, max_iters), NaN-padded
    accepted: torch.Tensor  # (B, max_iters) bool


def _per_factor(key, t, n):
    """Whether a ``data`` tensor carries the factor axis.  The one tensor a
    batch shares across its factors is a ``sqrt_info`` without that axis
    (``FactorBatch``'s convention)."""
    return t.dim() >= 1 and t.shape[0] == n and not (key == "sqrt_info" and t.dim() == 2)


def _unstack(graph: FactorGraph) -> list:
    """A pre-stacked graph (every tensor with a leading problem axis) as
    the list of its problems' graphs."""
    B = next(iter(graph.blocks.values())).values.shape[0]

    def pick(v, b):
        return v[b] if torch.is_tensor(v) else v

    return [
        FactorGraph(
            {n: VariableBlock(blk.kind, blk.values[b], blk.const_mask[b]) for n, blk in graph.blocks.items()},
            [FactorBatch(fb.kind, fb.slots, tuple(i[b] for i in fb.indices),
                         {k: pick(v, b) for k, v in fb.data.items()}, fb.loss, fb.weight[b])
             for fb in graph.batches],
        )
        for b in range(B)
    ]


@dataclasses.dataclass(frozen=True, eq=False)
class _ScalePerProblem:
    """A ``TDistributionLoss`` on a union batch of B problems of equal size,
    the residuals reshaped (B, n r): with ``scale`` None, the loss's own
    functions vmapped over the problems' rows, so each problem's scale is
    estimated from its own residuals (``TDistributionLoss(scale=None)``);
    with ``scale`` (B,), problem b's rows under the frozen scale b.  Equal
    only to itself: the B graphs of a batch share one."""

    base: TDistributionLoss
    B: int
    scale: torch.Tensor | None = None

    def _per_problem(self, name, e):
        rows = e.reshape(self.B, -1)
        if self.scale is None:
            out = torch.func.vmap(getattr(self.base, name))(rows)
        else:
            out = getattr(dataclasses.replace(self.base, scale=self.scale[:, None]), name)(rows)
        return out.reshape(e.shape)

    def loss(self, e):
        return self._per_problem("loss", e)

    def influence(self, e):
        return self._per_problem("influence", e)

    def weight(self, e):
        return self._per_problem("weight", e)


def _union(graphs: list) -> FactorGraph:
    """One graph of the B problems side by side (see the module docstring).
    Raises where the problems differ in structure: block names, kinds and
    sizes; batch kinds, slots, sizes and losses; a shared ``data`` tensor."""
    g0 = graphs[0]
    for g in graphs[1:]:
        if [(n, b.kind, tuple(b.values.shape)) for n, b in g.blocks.items()] != [
                (n, b.kind, tuple(b.values.shape)) for n, b in g0.blocks.items()]:
            raise ValueError("solve_batched: the graphs' variable blocks differ")
        if [(fb.kind, tuple(fb.slots), fb.n, fb.loss) for fb in g.batches] != [
                (fb.kind, tuple(fb.slots), fb.n, fb.loss) for fb in g0.batches]:
            raise ValueError("solve_batched: the graphs' factor batches differ (kind, slots, count or loss)")
    blocks = {
        n: VariableBlock(b.kind, torch.cat([g.blocks[n].values for g in graphs]),
                         torch.cat([g.blocks[n].const_mask for g in graphs]))
        for n, b in g0.blocks.items()
    }
    batches = []
    for k, fb in enumerate(g0.batches):
        loss = fb.loss
        if isinstance(loss, TDistributionLoss) and loss.scale is None:
            loss = _ScalePerProblem(loss, len(graphs))
        indices = tuple(
            torch.cat([g.batches[k].indices[s] + b * g0.blocks[slot].n for b, g in enumerate(graphs)])
            for s, slot in enumerate(fb.slots)
        )
        data = {}
        for key, v in fb.data.items():
            if torch.is_tensor(v) and _per_factor(key, v, fb.n):
                data[key] = torch.cat([g.batches[k].data[key] for g in graphs])
            else:
                if any(not (torch.equal(g.batches[k].data[key], v) if torch.is_tensor(v)
                            else g.batches[k].data[key] == v) for g in graphs[1:]):
                    raise ValueError(f"solve_batched: batch {k} data {key!r} is shared by its factors but "
                                     "differs between the graphs")
                data[key] = v
        batches.append(FactorBatch(fb.kind, fb.slots, indices, data, loss,
                                   torch.cat([g.batches[k].weight for g in graphs])))
    return FactorGraph(blocks, batches)


@dataclasses.dataclass(frozen=True)
class BatchedPlan:
    """The dense-assembly plan of B problems: ``assemble.DenseGroup``s whose
    positions index a (B·D, D) stack of Hessians and a (B·D,) gradient."""

    B: int
    D: int
    h_groups: tuple
    g_groups: tuple


def _batched_plan(graphs: list, device) -> BatchedPlan:
    """``assemble.dense_plan`` over the union's contribution order: in each
    batch, the factors of problem 0, then of problem 1, ...; the rows of
    problem b are offset by b·D.  Each problem's own indices give its
    positions.  Raises on a factor index outside its block."""
    g0 = graphs[0]
    D, B = g0.total_dof, len(graphs)
    offsets = g0.offsets()
    h_keys: dict[tuple, list] = {}
    g_keys: dict[tuple, list] = {}
    for k, fb in enumerate(g0.batches):
        rows, cols, dofs = [], [], []
        for s, slot in enumerate(fb.slots):
            blk = g0.blocks[slot]
            local = []
            for g in graphs:
                i = g.batches[k].indices[s].detach().cpu().numpy().astype(np.int64)
                if len(i) and (i.min() < 0 or i.max() >= blk.n):
                    raise ValueError(f"factor batch {fb.kind!r} slot {slot!r}: index out of range [0, {blk.n})")
                local.append(offsets[slot] + i * blk.dof)
            cols.append(np.concatenate(local))
            rows.append(np.concatenate([a + b * D for b, a in enumerate(local)]))
            dofs.append(blk.dof)
            g_keys.setdefault((blk.dof,), []).append(rows[-1])
        for a in range(len(rows)):
            for b in range(a, len(rows)):
                h_keys.setdefault((dofs[a], dofs[b]), []).append(rows[a] * D + cols[b])
                if b != a:
                    h_keys.setdefault((dofs[b], dofs[a]), []).append(rows[b] * D + cols[a])

    def groups(keys):
        return tuple(_group(s, np.concatenate(k), D, device) for s, k in keys.items())

    return BatchedPlan(B, D, groups(h_keys), groups(g_keys))


_PLANS = ClosureCache()


def _cached_batched_plan(graphs: list, device) -> BatchedPlan:
    """``_batched_plan``, reused across calls on fleets of one structure
    (``assemble.structure_key`` of each graph)."""
    key = (str(device),) + tuple(structure_key(g) for g in graphs)
    if key not in _PLANS:
        _PLANS[key] = _batched_plan(graphs, device)
    return _PLANS[key]


def _costs(union: FactorGraph, B: int):
    """Each problem's cost (B,), residuals only (``graph.chi2`` of each)."""
    blocks0 = next(iter(union.blocks.values())).values
    chi2 = torch.zeros(B, dtype=blocks0.dtype, device=blocks0.device)
    for fb in union.batches:
        r, _ = fb.evaluate(union.blocks, compute_jacobians=False)
        chi2 = chi2 + (fb.loss.loss(r) * fb.weight[:, None]).reshape(B, -1).sum(1)
    return chi2


def _assemble(union: FactorGraph, plan: BatchedPlan, free):
    """(H (B, D, D), g (B, D), chi2 (B,)) with ``assemble_dense``'s masks."""
    B, D = plan.B, plan.D
    h_parts, g_parts, chi2 = dense_contributions(union, hessian=True, problems=B)
    H = free.new_zeros(B * D * D)
    g = free.new_zeros(B * D)
    _reduce_into(H, plan.h_groups, h_parts, 1.0)
    _reduce_into(g, plan.g_groups, g_parts, -1.0)
    H = H.view(B, D, D)
    H.mul_(free[:, :, None])
    H.mul_(free[:, None, :])
    H.diagonal(dim1=1, dim2=2).add_(1.0 - free)
    return H, g.view(B, D) * free, chi2


def _solve_step(H, g, lam, opt: _lm.Options):
    """``lm._dense_solve`` of every problem: a unit diagonal where it is 0,
    Marquardt damping with each problem's λ, one batched Cholesky; NaN rows
    where a factorization fails."""
    Hd = H.clone()
    d = Hd.diagonal(dim1=1, dim2=2)
    d.add_((d == 0.0).to(H.dtype))
    if opt.method == "lm":
        d.add_(lam[:, None] * torch.clamp(d, min=1e-12))
    elif opt.gn_diag_floor > 0.0:
        d.add_(opt.gn_diag_floor)
    return cholesky_solve(Hd, g)


# lm.solve's dogleg step and trust-radius update, one problem a row
_dogleg_steps = torch.func.vmap(functools.partial(_lm._dogleg_step, matvec_fn=_lm._dense_matvec))


def _dogleg_radii(opt, delta, g, dx, H, cost_lin, cost_new, update_norm):
    def one(delta, g, dx, H, cost_lin, cost_new, update_norm):
        return _lm._dogleg_radius(opt, delta, g, dx, H, _lm._dense_matvec, cost_lin, cost_new, update_norm)

    return torch.func.vmap(one)(delta, g, dx, H, cost_lin, cost_new, update_norm)


def solve_batched(graphs, options: _lm.Options | None = None, return_info: bool = False):
    """Solve a FLEET of same-structure factor graphs in one batched LM loop.
    Use cases: Monte-Carlo uncertainty (resampled measurements), multi-robot
    fleets, measurement-hyperparameter sweeps.

    ``graphs``: a list of FactorGraphs with identical structure (same
    blocks, batch kinds, factor counts and losses; values, measurements and
    indices may differ), or one pre-stacked graph with a leading problem
    axis on every tensor.  Returns (solved values: dict name -> (B, ...),
    chi2 (B,)), each problem's best point and cost; with ``return_info``
    also a ``BatchedSolveInfo``."""
    opt = options if options is not None else _lm.Options()
    if opt.method not in ("lm", "gn", "dogleg"):
        raise ValueError(f"unknown method {opt.method!r}")
    dogleg = opt.method == "dogleg"
    graphs = list(graphs) if isinstance(graphs, (list, tuple)) else _unstack(graphs)
    B, K = len(graphs), opt.max_iters
    union = _union(graphs)
    blocks0 = next(iter(union.blocks.values())).values
    dtype, device = blocks0.dtype, blocks0.device
    plan = _cached_batched_plan(graphs, device)
    free = torch.stack([free_mask(g) for g in graphs]).to(dtype)
    sizes = {n: graphs[0].blocks[n].n for n in union.blocks}
    offsets = graphs[0].offsets()

    def to_union(dx):
        """(B, D) per-problem steps -> the union's tangent layout."""
        return torch.cat([dx[:, offsets[n]: offsets[n] + sizes[n] * b.dof].reshape(-1)
                          for n, b in union.blocks.items()])

    def select(mask, new, old):
        """The blocks of ``new`` for the problems in ``mask``, else ``old``."""
        out = {}
        for n, b in old.items():
            m = mask.repeat_interleave(sizes[n]).reshape((-1,) + (1,) * (b.values.dim() - 1))
            out[n] = VariableBlock(b.kind, torch.where(m, new[n].values, b.values), b.const_mask)
        return out

    if opt.speculative:
        H, g, cost_lin = _assemble(union, plan, free)
        init_cost = cost_lin
    else:
        init_cost = _costs(union, B)
    blocks = best_blocks = union.blocks
    cost = best_cost = init_cost
    lam = torch.full((B,), opt.trust_radius_init if dogleg else opt.lambda_init, dtype=dtype, device=device)
    nondec = torch.zeros(B, dtype=torch.int64, device=device)
    status = torch.full((B,), _lm.RUNNING, dtype=torch.int64, device=device)
    iterations = torch.zeros(B, dtype=torch.int64, device=device)
    max_nondec = opt.max_nondecreasing_steps if opt.allow_nondecreasing_steps else 1
    costs, lams, norms, accs = [init_cost], [], [], []
    codes = [_lm.RUNNING] * B
    it = 0
    while it < K and _lm.RUNNING in codes:
        cur = union.with_values(blocks)
        if not opt.speculative:
            H, g, cost_lin = _assemble(cur, plan, free)
        dx = _solve_step(H, g, lam, opt)
        if dogleg:
            dx, interior = _dogleg_steps(H, g, dx, lam)
        update_norm = torch.linalg.norm(dx, dim=1)
        trial = cur.retract_all(to_union(dx))
        if opt.speculative:
            H_t, g_t, cost_new = _assemble(trial, plan, free)
        else:
            cost_new = _costs(trial, B)

        running = status == _lm.RUNNING
        improved = cost_new < best_cost
        decrease_ok = cost_new < cost * opt.min_cost_decrease
        if opt.method == "lm":
            accept = cost_new < cost_lin  # False on NaN -> reject
            lam_next = torch.where(accept, torch.clamp(lam * opt.lambda_down, min=opt.lambda_min),
                                   torch.clamp(lam * opt.lambda_up, max=opt.lambda_max))
        elif dogleg:
            pred_pos, lam_next = _dogleg_radii(opt, lam, g, dx, H, cost_lin, cost_new, update_norm)
            accept = (cost_new < cost_lin) & pred_pos
        else:  # 'gn': unconditional step
            accept = torch.ones_like(running)
            lam_next = lam
        take, better = running & accept, running & improved
        lams.append(lam)
        blocks = select(take, trial.blocks, blocks)
        cost = torch.where(take, cost_new, cost)
        best_blocks = select(better, trial.blocks, best_blocks)
        best_cost = torch.where(better, cost_new, best_cost)
        nondec = torch.where(running, torch.where(improved, 0, nondec + 1), nondec)

        # stopping logic of lm.solve, for every problem at once
        s = torch.full_like(status, _lm.RUNNING)
        s = torch.where(accept & (update_norm < opt.min_update_norm), _lm.CONVERGED_UPDATE_NORM, s)
        s = torch.where(cost_new < opt.min_cost, _lm.CONVERGED_MIN_COST, s)
        if opt.method == "gn":
            s = torch.where((s == _lm.RUNNING) & improved & ~decrease_ok, _lm.CONVERGED_COST_DECREASE, s)
            s = torch.where((s == _lm.RUNNING) & (nondec >= max_nondec), _lm.STOPPED_NONDECREASING, s)
        else:  # lm, dogleg: an accepted step of small decrease (dogleg: one inside the region)
            small = (s == _lm.RUNNING) & accept & ~decrease_ok
            s = torch.where(small & interior if dogleg else small, _lm.CONVERGED_COST_DECREASE, s)
        if it + 1 == K:
            s = torch.where(s == _lm.RUNNING, _lm.MAX_ITERS, s)
        status = torch.where(running, s, status)
        lam = torch.where(running, lam_next, lam)
        iterations = iterations + running.to(torch.int64)

        costs.append(cost)
        norms.append(update_norm)
        accs.append(accept)
        if opt.speculative:
            H = torch.where(take[:, None, None], H_t, H)
            g = torch.where(take[:, None], g_t, g)
            cost_lin = torch.where(take, cost_new, cost_lin)
        it += 1
        with span("read"):
            codes = status.tolist()  # the one host read of the iteration
        HOST_READS["lm"] += 1

    values = {n: b.values.reshape((B, sizes[n]) + tuple(b.values.shape[1:])) for n, b in best_blocks.items()}
    if not return_info:
        return values, best_cost
    n_it = iterations.tolist()
    live = torch.arange(K, device=device)[None, :] < iterations[:, None]  # (B, K)

    def history(rows, length):
        out = torch.full((B, length), float("nan"), dtype=dtype, device=device)
        if rows:
            out[:, : len(rows)] = torch.stack(rows, dim=1)
        return out

    cost_h = history(costs, K + 1)
    cost_h[:, 1:] = torch.where(live, cost_h[:, 1:], float("nan"))
    acc = torch.zeros((B, K), dtype=torch.bool, device=device)
    if accs:
        acc[:, : len(accs)] = torch.stack(accs, dim=1)
    info = BatchedSolveInfo(
        chi2=best_cost, iterations=n_it, status=codes, cost_history=cost_h,
        lambda_history=torch.where(live, history(lams, K), float("nan")),
        update_norms=torch.where(live, history(norms, K), float("nan")), accepted=acc & live,
    )
    return values, best_cost, info


__all__ = ["BatchedSolveInfo", "solve_batched"]
