"""The solvers' spans and LM trial counts (``observability.span``,
``SPAN_NS`` / ``SPAN_CALLS``, ``linear.LM_TRIALS``) on the CPU: the spans
each layer records with the calls its structure implies, their nesting in
a profile, no profiler range without a profiler, the ``read`` spans against
``linear.HOST_READS``, the trials against the solves' own accept records,
and answers that a running profiler leaves in the same bits.  The port's
own feature: the JAX package has no counterpart."""

import pytest
import torch

from pyslam_tpu_torch import observability as obs
from pyslam_tpu_torch.graph import build
from pyslam_tpu_torch.io import synth
from pyslam_tpu_torch.solver import bcsr, lm
from pyslam_tpu_torch.solver import schur_large as sl
from pyslam_tpu_torch.solver.linear import HOST_READS, LM_TRIALS, reset_host_reads, reset_lm_trials
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = torch.float64

# the copies to the device a solve makes that wait for it and that
# ``HOST_READS`` does not count, each a ``read`` span: on the ELL path the
# device plan's eight tables and ``lm.solve``'s λ and accept record
UNCOUNTED = {"schur": 0, "ell": 8 + 2}


def _ba_graph():
    data = synth.ba_synthetic(n_cams=6, n_pts=40, obs_per_pt=3, seed=1)
    return build.ba_graph(data, dtype=F64, device="cpu")


def _pose_graph():
    return build.pose_graph(synth.se3_sphere(n_poses=60, seed=2), dtype=F64, device="cpu")


def _schur(speculative=True, **kw):
    return lambda: sl.solve_schur_large(_ba_graph(), lm.Options(max_iters=5, **kw), n_chunks=4,
                                        speculative=speculative)


def _ell(**kw):
    return lambda: bcsr.solve_ell(_pose_graph(), lm.Options(max_iters=4, **kw), pcg_max_iters=20)


def _counted(run):
    """Run a solve from zeroed totals: (its result, span calls, reads, trials)."""
    obs.reset_spans()
    reset_host_reads()
    reset_lm_trials()
    out = run()
    return out, dict(obs.SPAN_CALLS), sum(HOST_READS.values()), dict(LM_TRIALS)


@pytest.mark.parametrize("speculative", [True, False], ids=["speculative", "cost_pass"])
def test_schur_ba_records_each_layer(speculative):
    _, calls, reads, trials = _counted(_schur(speculative))
    n = calls["lm.iteration"]
    assert n >= 2 and n == trials["accepted"] + trials["rejected"]
    # the speculative loop linearizes once before its iterations, the other
    # once in each iteration (and costs each trial without Jacobians)
    lin = n + 1 if speculative else n
    expected = {"solve": 1, "plan": 1, "lm.iteration": n, "schur.linearize": lin, "schur.linearize.rows": lin,
                "schur.linearize.sums": lin, "schur.linearize.parts": lin, "schur.reduce": n, "schur.pcg": n,
                "schur.back_substitute": n, "read": reads}
    assert calls == expected
    # one read a trial, and the speculative loop's read of its first cost
    assert reads == lin
    ns = obs.SPAN_NS
    assert ns["solve"] >= ns["lm.iteration"] >= ns["schur.pcg"] > 0
    assert ns["schur.linearize"] >= ns["schur.linearize.rows"] + ns["schur.linearize.sums"] + ns["schur.linearize.parts"]


def test_ell_pose_graph_records_each_layer():
    _, calls, reads, trials = _counted(_ell())
    n = calls["lm.iteration"]
    assert n >= 2 and n == trials["accepted"] + trials["rejected"]
    # lm.solve's own solve span lies inside solve_ell's and counts once; the
    # plan is built inside the call, as no plan is passed
    expected = {"solve": 1, "plan": 1, "ell.device_plan": 1, "ell.assemble": n + 1, "ell.linear_solve": n,
                "lm.iteration": n, "lm.retract": n, "read": reads + UNCOUNTED["ell"]}
    assert calls == expected
    # on the CPU the linear solves read their stop test every CG iteration
    assert reads > n
    assert obs.SPAN_NS["solve"] >= obs.SPAN_NS["lm.iteration"] >= obs.SPAN_NS["ell.linear_solve"] > 0


@pytest.mark.parametrize("path,run", [("schur", _schur()), ("ell", _ell())], ids=["schur", "ell"])
def test_read_spans_are_the_host_reads(path, run):
    _, calls, reads, _ = _counted(run)
    assert reads > 0 and calls["read"] == reads + UNCOUNTED[path]


@pytest.mark.parametrize("run", [_schur(), _ell()], ids=["schur", "ell"])
def test_spans_nest_under_solve_in_a_profile(run):
    obs.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    names = set(obs.SPAN_CALLS)
    ranges = [e for e in prof.events() if e.name in names]
    (outer,) = [e for e in ranges if e.name == "solve"]
    for name, count in obs.SPAN_CALLS.items():
        assert sum(e.name == name for e in ranges) == count, name
    for e in ranges:
        assert outer.time_range.start <= e.time_range.start <= e.time_range.end <= outer.time_range.end, e.name


def test_no_profiler_range_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name) or real(name))
    _, calls, _, _ = _counted(_ell())
    assert calls["lm.iteration"] >= 2 and entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _counted(_ell())
    assert entered.count("solve") == 1 and entered.count("lm.iteration") == obs.SPAN_CALLS["lm.iteration"]


def _bad_first_step(solve_fn):
    """``solve_fn`` with its first step thrown far off, so that the first
    trial is rejected."""
    steps = []

    def solve(*args):
        dx = solve_fn(*args)
        steps.append(1)
        return dx * 50.0 if len(steps) == 1 else dx

    return solve


def test_lm_trials_match_the_dense_solve_info():
    g = build.pose_graph(synth.se2_loop(n_poses=20, seed=3), dtype=F64, device="cpu")
    (_, info), _, _, trials = _counted(lambda: lm.solve(g, lm.Options(max_iters=6),
                                                        solve_fn=_bad_first_step(lm._dense_solve)))
    acc = info.accepted[: info.iterations].tolist()
    assert acc[0] is False and trials == {"accepted": sum(acc), "rejected": len(acc) - sum(acc)}


@pytest.mark.parametrize("speculative", [True, False], ids=["speculative", "cost_pass"])
def test_lm_trials_match_the_host_loops(monkeypatch, speculative):
    # the first step's back-substitution scaled up, through the module
    # attribute by which the Schur solve calls it
    real = sl._back_substitute_retract
    steps = []

    def bad(parts, Hll_inv, poses, lms, x):
        steps.append(1)
        return real(parts, Hll_inv, poses, lms, x * 50.0 if len(steps) == 1 else x)

    monkeypatch.setattr(sl, "_back_substitute_retract", bad)
    (_, _, history), calls, _, trials = _counted(_schur(speculative))
    # ``history`` holds the start's cost and each accepted step's
    assert trials == {"accepted": len(history) - 1, "rejected": calls["lm.iteration"] - (len(history) - 1)}
    assert trials["rejected"] >= 1


@pytest.mark.parametrize("run", [_schur(), _ell()], ids=["schur", "ell"])
def test_answers_are_the_same_bits_under_a_profiler(run):
    plain = run()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = run()
    a, b = plain[0], profiled[0]
    for name in a.blocks:
        assert torch.equal(a.blocks[name].values, b.blocks[name].values)
    chi2 = (plain[1], profiled[1]) if isinstance(plain[1], float) else (plain[1].chi2, profiled[1].chi2)
    assert torch.equal(torch.as_tensor(chi2[0]), torch.as_tensor(chi2[1]))


def test_a_span_counts_once_at_its_outermost():
    obs.reset_spans()

    @obs.span("outer")
    def f(k):
        """A recursive body."""
        with obs.span("inner"):
            pass
        return f(k - 1) if k else 0

    assert f(3) == 0 and f.__name__ == "f" and f.__doc__ == "A recursive body."
    assert obs.SPAN_CALLS == {"outer": 1, "inner": 4}
    with pytest.raises(ValueError), obs.span("raised"):
        raise ValueError
    assert obs.SPAN_CALLS["raised"] == 1 and obs._DEPTH["raised"] == 0
    obs.reset_spans()
    assert obs.SPAN_NS == {} and obs.SPAN_CALLS == {}
