"""The shared host-side LM loop of the torch port (``solver/host_loop.py``)
against the JAX reference's (``pyslam_tpu/solver/host_loop.py``).

* The scripted-step cases of ``tests/test_host_loop.py``: each runs through
  both packages' ``host_lm_loop`` and must give the same history, best
  state, status, iteration count, lambdas and ``on_accept`` calls (exactly:
  the loops compare Python floats).
* The speculative loop against the classic one on the same scripted costs,
  in both packages: the same history, status and iterations.
* Step values given as 0-dim tensors: the port reads them in one host read
  an iteration and decides as with floats.
* A monotone accepted-cost history on ``ba_synthetic(8, 64)`` through
  ``solve_schur_large``, the loop's consumer, within 1e-9 relative of the
  reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import to_port

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import host_lm_loop as j_host_lm_loop
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu.solver.host_loop import host_lm_loop_speculative as j_host_lm_loop_speculative
from pyslam_tpu.solver.schur_large import solve_schur_large as j_solve_schur_large
from pyslam_tpu_torch.solver import host_lm_loop, host_lm_loop_speculative
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver.linear import HOST_READS, reset_host_reads
from pyslam_tpu_torch.solver.schur_large import solve_schur_large
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)


def scripted_step(costs, dx_norms=None, lams=None, wrap=float):
    """A step following a scripted trial-cost sequence; the state is the
    current cost (the reference test's helper)."""
    dx_norms = dx_norms or [1.0] * len(costs)
    calls = dict(k=0)

    def step(state, lam):
        if lams is not None:
            lams.append(lam)
        k = calls["k"]
        calls["k"] += 1
        trial = costs[min(k, len(costs) - 1)]
        return trial, wrap(state), wrap(trial), wrap(dx_norms[min(k, len(dx_norms) - 1)])

    return step


def scripted_speculative(costs, dx_norms=None):
    """The same script for the speculative loop: ``linearize`` of a state
    is its cost, ``solve_from`` proposes the next scripted trial."""
    dx_norms = dx_norms or [1.0] * len(costs)
    calls = dict(k=0)

    def linearize(state):
        return (state,)

    def solve_from(state, lin, lam):
        k = calls["k"]
        calls["k"] += 1
        return costs[min(k, len(costs) - 1)], dx_norms[min(k, len(dx_norms) - 1)]

    return linearize, solve_from


# (trial costs, update norms, initial cost, options) of tests/test_host_loop.py
CASES = {
    "lm_rejects_increases_and_tracks_best": ([50.0, 80.0, 20.0], None, 100.0,
                                             dict(method="lm", max_iters=3, min_cost_decrease=1.0)),
    "lambda_raises_on_reject": ([float("nan")], None, 10.0,
                                dict(method="lm", max_iters=4, lambda_init=1e-4, lambda_up=10.0)),
    "converged_cost_decrease": ([99.9], None, 100.0, dict(method="lm", max_iters=10, min_cost_decrease=0.99)),
    "converged_update_norm": ([50.0, 40.0], [1.0, 1e-12], 100.0,
                              dict(method="lm", max_iters=10, min_update_norm=1e-10, min_cost_decrease=1.0)),
    "converged_min_cost": ([1e-40], None, 100.0, dict(method="lm", max_iters=10, min_cost=1e-30)),
    "gn_nondecreasing_budget": ([50.0, 60.0, 70.0, 80.0, 90.0], None, 100.0,
                                dict(method="gn", max_iters=10, allow_nondecreasing_steps=True,
                                     max_nondecreasing_steps=3, min_cost_decrease=1.0)),
    "checkpoint_hook_on_accepts_only": ([50.0, 80.0, 20.0, 10.0], None, 100.0,
                                        dict(method="lm", max_iters=4, min_cost_decrease=1.0)),
    "gn_cost_decrease": ([95.0, 94.9], None, 100.0, dict(method="gn", max_iters=10, min_cost_decrease=0.99)),
    "gn_stops_on_nondecrease_without_budget": ([120.0], None, 100.0, dict(method="gn", max_iters=10)),
}


def _run(loop, options_cls, case, wrap=float):
    costs, dx, init, kw = CASES[case]
    lams, calls = [], []
    best, hist, info = loop(scripted_step(costs, dx, lams, wrap), init, options_cls(**kw),
                            on_accept=lambda s, lam, n: calls.append((s, lam, n)))
    return best, hist, info, lams, calls


def _same(a, b):
    """Equal, with NaN equal to NaN."""
    return np.array_equal(np.asarray(a, float), np.asarray(b, float), equal_nan=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_scripted_steps_match_the_reference(case):
    jb, jh, ji, jl, jc = _run(j_host_lm_loop, jlm.Options, case)
    tb, th, ti, tl, tc = _run(host_lm_loop, tlm.Options, case)
    assert _same(th, jh) and _same([tb], [jb])
    assert (ti["status"], ti["iterations"]) == (ji["status"], ji["iterations"])
    assert _same([ti["chi2"]], [ji["chi2"]])
    assert tl == jl
    assert tc == jc


def test_reference_expectations():
    """The reference test's own assertions, on the port."""
    _, hist, info, _, _ = _run(host_lm_loop, tlm.Options, "lm_rejects_increases_and_tracks_best")
    assert hist == [100.0, 50.0, 20.0] and info["chi2"] == 20.0 and info["status"] == tlm.MAX_ITERS
    _, hist, info, lams, _ = _run(host_lm_loop, tlm.Options, "lambda_raises_on_reject")
    np.testing.assert_allclose(lams, [1e-4, 1e-3, 1e-2, 1e-1])
    assert hist == [10.0] and info["status"] == tlm.MAX_ITERS
    assert _run(host_lm_loop, tlm.Options, "converged_cost_decrease")[2]["iterations"] == 1
    assert _run(host_lm_loop, tlm.Options, "converged_update_norm")[2]["status"] == tlm.CONVERGED_UPDATE_NORM
    assert _run(host_lm_loop, tlm.Options, "converged_min_cost")[2]["status"] == tlm.CONVERGED_MIN_COST
    info = _run(host_lm_loop, tlm.Options, "gn_nondecreasing_budget")[2]
    assert info["status"] == tlm.STOPPED_NONDECREASING and info["chi2"] == 50.0
    calls = _run(host_lm_loop, tlm.Options, "checkpoint_hook_on_accepts_only")[4]
    assert [(s, n) for s, _, n in calls] == [(50.0, 1), (20.0, 2), (10.0, 3)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_values_read_once_an_iteration(case):
    """0-dim tensors for chi2, cost and update norm: the same decisions as
    Python floats, one host read an iteration."""
    fb, fh, fi, fl, _ = _run(host_lm_loop, tlm.Options, case)
    reset_host_reads()
    tb, th, ti, tl, _ = _run(host_lm_loop, tlm.Options, case,
                             wrap=lambda v: torch.tensor(v, dtype=torch.float64))
    assert _same(th, fh) and (ti["status"], ti["iterations"]) == (fi["status"], fi["iterations"]) and tl == fl
    assert HOST_READS["lm"] == ti["iterations"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_speculative_matches_classic(case):
    costs, dx, init, kw = CASES[case]
    for spec, classic, opt in ((host_lm_loop_speculative, host_lm_loop, tlm.Options),
                               (j_host_lm_loop_speculative, j_host_lm_loop, jlm.Options)):
        sb, sh, si = spec(*scripted_speculative(costs, dx), init, opt(**kw))
        cb, ch, ci = classic(scripted_step(costs, dx), init, opt(**kw))
        assert _same(sh, ch) and _same([sb], [cb])
        assert (si["status"], si["iterations"]) == (ci["status"], ci["iterations"])
    tb, th, ti = host_lm_loop_speculative(*scripted_speculative(costs, dx), init, tlm.Options(**kw))
    jb, jh, ji = j_host_lm_loop_speculative(*scripted_speculative(costs, dx), init, jlm.Options(**kw))
    assert _same(th, jh) and (ti["status"], ti["iterations"]) == (ji["status"], ji["iterations"])


def test_monotone_history_on_bundle_adjustment():
    jg = jbuild.ba_graph(jsynth.ba_synthetic(n_cams=8, n_pts=64, seed=3), dtype=jnp.float64)
    tg = to_port(jg)
    _, chi2, hist = solve_schur_large(tg, tlm.Options(method="lm", max_iters=12))
    _, j_chi2, j_hist = j_solve_schur_large(jg, jlm.Options(method="lm", max_iters=12))
    assert all(b < a for a, b in zip(hist, hist[1:]))
    assert chi2 <= hist[0] and len(hist) == len(j_hist)
    np.testing.assert_allclose(hist, j_hist, rtol=1e-9)
