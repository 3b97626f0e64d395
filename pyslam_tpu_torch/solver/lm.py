"""Gauss-Newton / Levenberg-Marquardt / dogleg solver loop.

Counterpart of ``pyslam_tpu/solver/lm.py``: ``solve`` and
``solve_one_iter``, with the same options, accept/reject rule, trust-region
update, best-point tracking and stop codes.  The reference runs the whole
solve on the device under one ``lax.while_loop``; here the loop runs on
the host and makes one device-to-host read per iteration, which brings
back every comparison the accept and stop logic needs (computed on the
device in the graph's dtype, as in the reference).  The trust radius of
'dogleg' is updated on the device and needs no read of its own.

A solve is a ``solve`` span and each iteration an ``lm.iteration`` span,
holding the ``lm.retract`` span and the flag read's ``read`` span.  The
copies of the damping and of the accept record to the device wait for it,
so they are ``read`` spans too, though ``HOST_READS`` does not count them.
``linear.LM_TRIALS`` counts the accept decisions.

The default linear path is dense: ``assemble_dense`` (over the plan of
the graph's structure, built once and kept by ``cached_dense_plan``) and
``_dense_solve`` (Marquardt damping and Cholesky).  A failed Cholesky
gives a NaN step, whose cost compares False with everything, so the step
is rejected without a branch.  The sparse paths
pass their own ``assemble_fn`` / ``solve_fn`` / ``matvec_fn``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..graph.core import FactorGraph
from ..observability import span
from .assemble import assemble_dense, cached_dense_plan, unit_diag_where_dead_
from .linear import HOST_READS, LM_TRIALS, cholesky_solve, damp_marquardt_

# Stop codes (SolveInfo.status)
RUNNING = 0
MAX_ITERS = 1
CONVERGED_UPDATE_NORM = 2
CONVERGED_MIN_COST = 3
CONVERGED_COST_DECREASE = 4
STOPPED_NONDECREASING = 5

STATUS_NAMES = {
    MAX_ITERS: "max_iters",
    CONVERGED_UPDATE_NORM: "update_norm < min_update_norm",
    CONVERGED_MIN_COST: "cost < min_cost",
    CONVERGED_COST_DECREASE: "insufficient cost decrease",
    STOPPED_NONDECREASING: "nondecreasing steps",
}


@dataclasses.dataclass(frozen=True)
class Options:
    """Solver knobs, field for field the reference's ``Options``."""

    # --- reference-parity fields ---
    max_iters: int = 100
    min_update_norm: float = 1e-10
    min_cost: float = 1e-30
    min_cost_decrease: float = 0.99
    allow_nondecreasing_steps: bool = False
    max_nondecreasing_steps: int = 3
    # --- solver extensions ---
    method: str = "lm"  # 'gn' (reference) | 'lm' (damping) | 'dogleg' (trust region)
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    lambda_min: float = 1e-12
    lambda_max: float = 1e8
    gn_diag_floor: float = 0.0  # tiny diagonal added in GN mode if gauge-free
    # --- dogleg trust-region knobs (method='dogleg') ---
    trust_radius_init: float = 1.0
    trust_radius_max: float = 1e6
    trust_radius_min: float = 1e-12
    # --- speculative linearization ---
    # Evaluate each trial point with a full linearization instead of a
    # cost-only pass: on accept, the trial assembly is the next iteration's
    # linearization.  Cost comparisons then use the assembly-path chi2 on
    # both sides.
    speculative: bool = True


class SolveInfo(NamedTuple):
    chi2: torch.Tensor  # best cost reached (0-dim, on the graph's device)
    iterations: int
    status: int  # stop code, see STATUS_NAMES
    cost_history: torch.Tensor  # (max_iters + 1,), NaN-padded
    lambda_history: torch.Tensor  # (max_iters,), NaN-padded
    update_norms: torch.Tensor  # (max_iters,), NaN-padded
    accepted: torch.Tensor  # (max_iters,) bool


def _history(values, length, dtype, device):
    out = torch.full((length,), float("nan"), dtype=dtype, device=device)
    if values:
        out[: len(values)] = torch.stack(values)
    return out


def _dogleg_step(H, g, dx_gn, delta, matvec_fn):
    """Powell's dogleg: blend the (undamped) GN step with the Cauchy point
    inside the trust region of radius ``delta``.  All three cases are
    evaluated and selected on the device.  g is the NEGATIVE gradient (rhs
    of H dx = g), so it is the descent direction.  Returns (dx, interior),
    interior a 0-dim bool tensor: the full GN step fits the region."""
    tiny = 1e-30
    gg = torch.dot(g, g)
    gHg = torch.dot(g, matvec_fn(H, g))
    alpha = gg / torch.clamp(gHg, min=tiny)
    dx_sd = alpha * g
    n_gn = torch.linalg.norm(dx_gn)
    n_sd = torch.linalg.norm(dx_sd)
    d = dx_gn - dx_sd
    a2 = torch.clamp(torch.dot(d, d), min=tiny)
    b2 = torch.dot(dx_sd, d)
    c2 = torch.dot(dx_sd, dx_sd) - delta * delta
    disc = torch.sqrt(torch.clamp(b2 * b2 - a2 * c2, min=0.0))
    beta = (-b2 + disc) / a2
    dx_interp = dx_sd + beta * d
    dx_sd_clamped = (delta / torch.clamp(n_sd, min=tiny)) * dx_sd
    # NaN-safety: a singular H gives a NaN GN step, both n_gn comparisons
    # are then False, so the finite steepest-descent branch stays reachable
    # once delta shrinks below ||dx_sd||
    interior = n_gn <= delta
    dx = torch.where(interior, dx_gn, torch.where(n_sd >= delta, dx_sd_clamped, dx_interp))
    return dx, interior


def _dogleg_radius(opt, delta, g, dx, H, matvec_fn, cost_lin, cost_new, update_norm):
    """(pred > 0, next radius): the gain ratio rho = actual / predicted
    decrease of the quadratic model m(dx) = cost - g.dx + 0.5 dx.H.dx sets
    the next radius, on the device."""
    pred = torch.dot(g, dx) - 0.5 * torch.dot(dx, matvec_fn(H, dx))
    rho = (cost_lin - cost_new) / torch.clamp(pred, min=1e-30)
    accept = (cost_new < cost_lin) & (pred > 0)  # False on NaN
    grow = (rho > 0.75) & (update_norm > 0.8 * delta)
    shrink = ~accept | (rho < 0.25)
    lam = torch.where(grow, 2.0 * delta, torch.where(shrink, 0.25 * delta, delta))
    return pred > 0, torch.clamp(lam, opt.trust_radius_min, opt.trust_radius_max)


@span("solve")
def solve(
    graph: FactorGraph,
    options: Options = Options(),
    assemble_fn=None,
    solve_fn=None,
    matvec_fn=None,
):
    """Run GN/LM/dogleg to convergence.  Returns (solved_graph, SolveInfo).

    ``assemble_fn(graph) -> (H, g, chi2)`` and ``solve_fn(H, g, lam,
    options) -> dx`` default to the dense path; the sparse paths pass their
    own.  ``matvec_fn(H, v) -> Hv`` (default dense ``H @ v``) is needed
    only by 'dogleg', which evaluates the quadratic model at the composite
    step; with a custom linear path 'dogleg' requires it.
    """
    opt = options
    if opt.method not in ("lm", "gn", "dogleg"):
        raise ValueError(f"unknown method {opt.method!r}")
    if matvec_fn is None:
        if opt.method == "dogleg" and (
            assemble_fn not in (None, assemble_dense) or solve_fn not in (None, _dense_solve)
        ):
            raise ValueError("method='dogleg' with a custom linear path needs matvec_fn(H, v)")
        matvec_fn = _dense_matvec
    if assemble_fn is None or assemble_fn is assemble_dense:
        plan = cached_dense_plan(graph)

        def assemble_fn(g):
            return assemble_dense(g, plan)

    if solve_fn is None:
        solve_fn = _dense_solve
    blocks0 = next(iter(graph.blocks.values())).values
    dtype, device = blocks0.dtype, blocks0.device
    K = opt.max_iters
    dogleg = opt.method == "dogleg"

    if opt.speculative:
        # one assembly before the loop seeds the carried linearization; its
        # chi2 is the initial cost so every comparison stays on the
        # assembly summation path
        H, g, cost_lin = assemble_fn(graph)
        init_cost = cost_lin
    else:
        init_cost = graph.chi2()
    blocks = best_blocks = graph.blocks
    cost = best_cost = init_cost
    with span("read"):  # a copy to the device, which waits for it
        lam = torch.tensor(opt.trust_radius_init if dogleg else opt.lambda_init, dtype=dtype, device=device)
    nondec = 0
    status = RUNNING
    it = 0
    costs, lams, norms, accs = [init_cost], [], [], []

    while it < K and status == RUNNING:
        with span("lm.iteration"):
            g_cur = graph.with_values(blocks)
            if not opt.speculative:
                H, g, cost_lin = assemble_fn(g_cur)
            dx = solve_fn(H, g, lam, opt)
            if dogleg:
                dx, interior = _dogleg_step(H, g, dx, lam, matvec_fn)
            with span("lm.retract"):
                update_norm = torch.linalg.norm(dx)
                trial = g_cur.retract_all(dx)
            if opt.speculative:
                H_t, g_t, cost_new = assemble_fn(trial)
            else:
                cost_new = trial.chi2()

            # every comparison on the device in the graph's dtype; one read
            checks = [
                cost_new < cost_lin,
                cost_new < best_cost,
                cost_new < cost * opt.min_cost_decrease,
                update_norm < opt.min_update_norm,
                cost_new < opt.min_cost,
            ]
            if dogleg:
                pred_pos, lam_next = _dogleg_radius(
                    opt, lam, g, dx, H, matvec_fn, cost_lin, cost_new, update_norm
                )
                checks += [pred_pos, interior]
            stacked = torch.stack(checks)
            with span("read"):
                flags = stacked.tolist()
            HOST_READS["lm"] += 1
            lm_accept, improved, decrease_ok, small_update, below_min_cost = flags[:5]

            lams.append(lam)
            if opt.method == "lm":
                accept = lm_accept  # False on NaN -> reject
                if accept:
                    lam = torch.clamp(lam * opt.lambda_down, min=opt.lambda_min)
                else:
                    lam = torch.clamp(lam * opt.lambda_up, max=opt.lambda_max)
            elif dogleg:
                accept = lm_accept and flags[5]  # and pred > 0
                lam = lam_next
            else:  # 'gn': unconditional step, reference behavior
                accept = True
            LM_TRIALS["accepted" if accept else "rejected"] += 1

            if accept:
                blocks = trial.blocks
                cost = cost_new
            if improved:
                best_blocks = trial.blocks
                best_cost = cost_new
                nondec = 0
            else:
                nondec += 1

            # --- stopping logic (reference semantics) ---
            max_nondec = opt.max_nondecreasing_steps if opt.allow_nondecreasing_steps else 1
            if accept and small_update:
                status = CONVERGED_UPDATE_NORM
            if below_min_cost:
                status = CONVERGED_MIN_COST
            if opt.method == "gn":
                # GN stops when the cost stops decreasing fast enough ...
                if status == RUNNING and improved and not decrease_ok:
                    status = CONVERGED_COST_DECREASE
                # ... or has not improved for max_nondecreasing_steps.
                if status == RUNNING and nondec >= max_nondec:
                    status = STOPPED_NONDECREASING
            elif status == RUNNING and accept and not decrease_ok and (not dogleg or flags[6]):
                # LM/dogleg: 'converged' when an accepted step yields a tiny
                # relative decrease; rejected steps just shrink the region.
                # Dogleg also requires the step to have been interior: a
                # radius-limited step with small decrease means the region is
                # still growing, not that the optimum is reached.
                status = CONVERGED_COST_DECREASE

            costs.append(cost)
            norms.append(update_norm)
            accs.append(accept)
            if opt.speculative and accept:
                H, g, cost_lin = H_t, g_t, cost_new
            it += 1

    if status == RUNNING:
        status = MAX_ITERS
    accepted = torch.zeros(K, dtype=torch.bool, device=device)
    with span("read"):
        accepted[: len(accs)] = torch.tensor(accs, dtype=torch.bool, device=device)
    info = SolveInfo(
        chi2=best_cost,
        iterations=it,
        status=status,
        cost_history=_history(costs, K + 1, dtype, device),
        lambda_history=_history(lams, K, dtype, device),
        update_norms=_history(norms, K, dtype, device),
        accepted=accepted,
    )
    return graph.with_values(best_blocks), info


def _dense_matvec(H, v):
    return H @ v


def _dense_solve(H, g, lam, opt: Options):
    """Damped dense solve on one copy of H (H itself is kept: a rejected
    step reuses it)."""
    Hd = unit_diag_where_dead_(H.clone())
    if opt.method == "lm":
        damp_marquardt_(Hd, lam)
    elif opt.gn_diag_floor > 0.0:
        Hd.diagonal().add_(opt.gn_diag_floor)
    return cholesky_solve(Hd, g)


def solve_one_iter(graph: FactorGraph, options: Options = Options()):
    """Single GN/LM step on the dense path.  Returns (updated_graph, dx,
    chi2_at_linearization)."""
    H, g, chi2 = assemble_dense(graph)
    dx = _dense_solve(H, g, torch.tensor(options.lambda_init, dtype=H.dtype, device=H.device), options)
    return graph.retract_all(dx), dx, chi2
