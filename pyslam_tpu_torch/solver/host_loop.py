"""Shared host-side LM trust-region loop for solvers that drive one step an
iteration from the host.

Counterpart of ``pyslam_tpu/solver/host_loop.py``: ``host_lm_loop`` and
``host_lm_loop_speculative`` with the reference's accept / reject rule,
best-state tracking, stop rules and ``on_accept`` hook, field for field the
``Options`` of ``solver/lm.py``.  ``solver/schur_large.py`` runs on it.
``lm.solve`` keeps its own loop, which reads its comparisons as device
booleans; this one compares Python floats, as the reference does, and
returns the reference's ``history`` list and ``info`` dict.

The values a step returns may be Python floats or 0-dim tensors; the loop
brings the tensors of one iteration to the host in one read
(``linear.HOST_READS["lm"]`` counts such reads, each a ``read`` span).  Each
iteration is an ``lm.iteration`` span, and its accept decision is counted in
``linear.LM_TRIALS``.
"""

from __future__ import annotations

import torch

from ..observability import span
from . import lm as _lm
from .linear import HOST_READS, LM_TRIALS


def _floats(*values):
    """``values`` as Python floats, the tensors among them read from their
    device together."""
    tensors = [v for v in values if torch.is_tensor(v)]
    if not tensors:
        return [float(v) for v in values]
    HOST_READS["lm"] += 1
    # f64 holds every f32 value exactly: the floats are those float(t) gives
    stacked = torch.stack([t.detach().reshape(()).to(torch.float64) for t in tensors])
    with span("read"):
        read = iter(stacked.tolist())
    return [next(read) if torch.is_tensor(v) else float(v) for v in values]


def _max_nondec(options):
    return options.max_nondecreasing_steps if options.allow_nondecreasing_steps else 1


def _stop(options, accept, improved, dx_norm, cost_new, prev_cost, nondec):
    """The stop code after one iteration, or ``lm.RUNNING`` (the order and
    conditions of ``solver/lm.py``)."""
    if accept and dx_norm < options.min_update_norm:
        return _lm.CONVERGED_UPDATE_NORM
    if cost_new < options.min_cost:
        return _lm.CONVERGED_MIN_COST
    decrease_ok = cost_new < prev_cost * options.min_cost_decrease
    if options.method == "gn":
        if improved and not decrease_ok:
            return _lm.CONVERGED_COST_DECREASE
        if nondec >= _max_nondec(options):
            return _lm.STOPPED_NONDECREASING
    elif accept and not decrease_ok:
        return _lm.CONVERGED_COST_DECREASE
    return _lm.RUNNING


def host_lm_loop(step, state, options: _lm.Options, on_accept=None):
    """Run the GN/LM accept-reject loop over a host-driven step.

    ``step(state, lam) -> (trial_state, chi2, cost_new, dx_norm)`` where
    ``chi2`` is the cost at the linearization point (current state) and
    ``cost_new`` the trial-state cost.  ``state`` is anything the caller
    threads through; ``lam`` arrives as a Python float.

    ``on_accept(state, lam, n_accepted)`` is called after every accepted
    step (checkpoint hook).

    Returns ``(best_state, history, info)`` with ``history`` the accepted
    cost sequence (initial cost first) and ``info`` a dict with ``status``
    (``solver.lm`` stop code), ``iterations``, and ``chi2`` (best cost).

    LM accepts iff cost_new < chi2, so a NaN cost (a failed factorization)
    is a rejection; GN always accepts.  Stopping: update norm (accepted
    steps only), min_cost, insufficient relative decrease (accepted steps
    in LM; improved steps in GN), and the GN nondecreasing-step budget.
    """
    lam = options.lambda_init
    best_state, best_cost = state, float("inf")
    nondec = 0
    history: list[float] = []
    status = _lm.RUNNING
    it = 0
    n_accepted = 0
    for it in range(1, options.max_iters + 1):
        with span("lm.iteration"):
            trial, chi2, cost_new, dx_norm = step(state, lam)
            chi2, cost_new, dx_norm = _floats(chi2, cost_new, dx_norm)
            if not history:
                history.append(chi2)
                best_cost = chi2

            accept = (options.method == "gn") or (cost_new < chi2)
            LM_TRIALS["accepted" if accept else "rejected"] += 1
            if accept:
                state = trial
                history.append(cost_new)
                lam = max(lam * options.lambda_down, options.lambda_min)
                n_accepted += 1
                if on_accept is not None:
                    on_accept(state, lam, n_accepted)
            else:
                lam = min(lam * options.lambda_up, options.lambda_max)

            improved = cost_new < best_cost
            if improved:
                best_state, best_cost = trial, cost_new
                nondec = 0
            else:
                nondec += 1
            status = _stop(options, accept, improved, dx_norm, cost_new, chi2, nondec)
        if status != _lm.RUNNING:
            break

    if status == _lm.RUNNING:
        status = _lm.MAX_ITERS
    return best_state, history, dict(status=status, iterations=it, chi2=best_cost)


def host_lm_loop_speculative(linearize, solve_from, state, options: _lm.Options, on_accept=None):
    """Speculative-linearization variant of :func:`host_lm_loop`.

    The trial state is evaluated with a full gradient linearization: on
    accept, that linearization is the one the next solve needs; on reject,
    the current one is solved again at a higher lambda.  One gradient
    linearization an iteration and no cost-only pass; the accept / reject
    and stop decisions read the same costs as ``host_lm_loop``, so the
    iterate sequence is the same.

    ``linearize(state) -> lin`` with ``lin[0]`` the cost at ``state``; the
    rest of ``lin`` is whatever ``solve_from`` needs.
    ``solve_from(state, lin, lam) -> (trial_state, dx_norm)``.  The update
    norm and the trial cost are read in one host read.
    """
    lam = options.lambda_init
    lin = linearize(state)
    (chi2,) = _floats(lin[0])
    history: list[float] = [chi2]
    best_state, best_cost = state, chi2
    nondec = 0
    status = _lm.RUNNING
    it = 0
    n_accepted = 0
    for it in range(1, options.max_iters + 1):
        with span("lm.iteration"):
            trial, dx_norm = solve_from(state, lin, lam)
            lin_trial = linearize(trial)
            dx_norm, cost_new = _floats(dx_norm, lin_trial[0])
            prev_chi2 = chi2

            accept = (options.method == "gn") or (cost_new < chi2)
            LM_TRIALS["accepted" if accept else "rejected"] += 1
            if accept:
                state, lin, chi2 = trial, lin_trial, cost_new
                history.append(cost_new)
                lam = max(lam * options.lambda_down, options.lambda_min)
                n_accepted += 1
                if on_accept is not None:
                    on_accept(state, lam, n_accepted)
            else:
                lam = min(lam * options.lambda_up, options.lambda_max)
            del lin_trial  # a rejected trial's linearization is not kept

            improved = cost_new < best_cost
            if improved:
                best_state, best_cost = trial, cost_new
                nondec = 0
            else:
                nondec += 1
            status = _stop(options, accept, improved, dx_norm, cost_new, prev_chi2, nondec)
        if status != _lm.RUNNING:
            break

    if status == _lm.RUNNING:
        status = _lm.MAX_ITERS
    return best_state, history, dict(status=status, iterations=it, chi2=best_cost)


__all__ = ["host_lm_loop", "host_lm_loop_speculative"]
