"""Gauss-Newton / Levenberg-Marquardt solver loop.

Counterpart of ``pyslam_tpu/solver/lm.py::solve``, with the same options,
accept/reject rule, best-point tracking and stop codes.  The reference
runs the whole solve on the device under one ``lax.while_loop``; here the
loop runs on the host and makes one device-to-host read per LM iteration,
which brings back every comparison the accept and stop logic needs
(computed on the device in the graph's dtype, as in the reference).

Ported so far: ``method`` 'lm' and 'gn', speculative or classic
linearization, with the caller's ``assemble_fn`` / ``solve_fn`` (the
sparse paths pass their own).  'dogleg' and the dense default path come
with a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..graph.core import FactorGraph
from .linear import HOST_READS

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
    method: str = "lm"  # 'gn' (reference) | 'lm' (damping) | 'dogleg' (not ported yet)
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


def solve(
    graph: FactorGraph,
    options: Options = Options(),
    assemble_fn=None,
    solve_fn=None,
    matvec_fn=None,
):
    """Run GN/LM to convergence.  Returns (solved_graph, SolveInfo).

    ``assemble_fn(graph) -> (H, g, chi2)`` and ``solve_fn(H, g, lam,
    options) -> dx`` define the linear path (``solver.bcsr.solve_ell``
    passes its own).  ``matvec_fn`` is accepted for the reference's
    signature; only 'dogleg' would use it.
    """
    opt = options
    if opt.method == "dogleg":
        raise NotImplementedError("method='dogleg' is not ported yet")
    if opt.method not in ("lm", "gn"):
        raise ValueError(f"unknown method {opt.method!r}")
    if assemble_fn is None or solve_fn is None:
        raise NotImplementedError("the dense default path is not ported yet: pass assemble_fn and solve_fn")
    blocks0 = next(iter(graph.blocks.values())).values
    dtype, device = blocks0.dtype, blocks0.device
    K = opt.max_iters

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
    lam = torch.tensor(opt.lambda_init, dtype=dtype, device=device)
    nondec = 0
    status = RUNNING
    it = 0
    costs, lams, norms, accs = [init_cost], [], [], []

    while it < K and status == RUNNING:
        g_cur = graph.with_values(blocks)
        if not opt.speculative:
            H, g, cost_lin = assemble_fn(g_cur)
        dx = solve_fn(H, g, lam, opt)
        update_norm = torch.linalg.norm(dx)
        trial = g_cur.retract_all(dx)
        if opt.speculative:
            H_t, g_t, cost_new = assemble_fn(trial)
        else:
            cost_new = trial.chi2()

        # every comparison on the device in the graph's dtype; one read
        flags = torch.stack(
            [
                cost_new < cost_lin,
                cost_new < best_cost,
                cost_new < cost * opt.min_cost_decrease,
                update_norm < opt.min_update_norm,
                cost_new < opt.min_cost,
            ]
        ).tolist()
        HOST_READS["lm"] += 1
        lm_accept, improved, decrease_ok, small_update, below_min_cost = flags

        lams.append(lam)
        if opt.method == "lm":
            accept = lm_accept  # False on NaN -> reject
            if accept:
                lam = torch.clamp(lam * opt.lambda_down, min=opt.lambda_min)
            else:
                lam = torch.clamp(lam * opt.lambda_up, max=opt.lambda_max)
        else:  # 'gn': unconditional step, reference behavior
            accept = True

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
        elif status == RUNNING and accept and not decrease_ok:
            # LM: 'converged' when an accepted step yields a tiny relative
            # decrease; rejected steps just raise lambda and continue
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
