"""The metrics that read the program's own spans and trial counter
(``host_wait_ms``, ``host_work_ms``, ``ell_plan_ms``, ``lm_rejected``): each
cell's traced run prints those it names; the solve's work and waits make up
its host time; the program's spans agree with the benchmark's wrappers
around the same calls; and a program without the totals gives no reading
and raises nothing."""

import time
import types

import pytest
from conftest import ROOT, small_config

from portbench import harness, probes, spans

MANIFEST = harness.load_manifest(ROOT)
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NEW = ("host_wait_ms", "host_work_ms", "ell_plan_ms", "lm_rejected")

# what the cases below read beside the metrics: the steady solves' mean time
# and the program's spans of the layers the wrappers time
EXTRA = {
    "steady_solve_ms": lambda run: 1e3 * sum(run.solves[i].seconds for i in run.steady()) / len(run.steady()),
    "linearize_span_ms": lambda run: spans.steady_ms(run, "schur.linearize"),
    "pcg_span_ms": lambda run: spans.steady_ms(run, "schur.pcg"),
}
_RUNS: dict = {}


def _traced(cell, device, monkeypatch):
    """One traced run of the cell at its small size, with the extra readings,
    kept for every case of the module."""
    if (cell, device) not in _RUNS:
        extra = {"steady_solve_ms": types.SimpleNamespace(PROBES=[], read=EXTRA["steady_solve_ms"]),
                 "linearize_span_ms": types.SimpleNamespace(PROBES=[spans.span_ns("schur.linearize")],
                                                            read=EXTRA["linearize_span_ms"]),
                 "pcg_span_ms": types.SimpleNamespace(PROBES=[spans.span_ns("schur.pcg")], read=EXTRA["pcg_span_ms"])}
        real = harness.reader
        monkeypatch.setattr(harness, "reader", lambda name: extra.get(name) or real(name))
        manifest = dict(MANIFEST, per_layer=MANIFEST["per_layer"] + [
            dict(name=n, unit="ms", better="lower", source="program_span", layer="test", moves="solve_ms")
            for n in extra])
        _RUNS[(cell, device)] = harness.run_cell(manifest, cell, 2**31 + 7, 1.0, True, device, time.perf_counter(),
                                                 config=small_config(cell))
    return _RUNS[(cell, device)]


def _value(result, name):
    return result["metrics"][name]["value"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_run_prints_the_metrics_it_names(cell, device, monkeypatch):
    result = _traced(cell, device, monkeypatch)
    named = {m["name"] for m in harness.metrics_for(MANIFEST, cell, True) if harness.reader_name(m["name"]) in NEW}
    assert named and named <= set(result["metrics"]) and result["correct"] is True
    assert all(_value(result, n) >= 0 for n in named)


@pytest.mark.parametrize("cell", CELLS)
def test_work_and_waits_make_up_the_solve(cell, device, monkeypatch):
    result = _traced(cell, device, monkeypatch)
    host = _value(result, "host_work_ms") + _value(result, "host_wait_ms")
    assert 0.9 * _value(result, "steady_solve_ms") <= host <= _value(result, "steady_solve_ms")


WRAPPED = (("linearize_span_ms", "linearize_ms"), ("pcg_span_ms", "schur_pcg_ms"))
# each cell's metrics read by a wrapper's reader, beside the program's span
AGREE = [(c, s, m["name"]) for s, w in WRAPPED for c in CELLS for m in harness.metrics_for(MANIFEST, c, True)
         if harness.reader_name(m["name"]) == w]


@pytest.mark.parametrize("cell,span,wrapper", AGREE)
def test_the_program_spans_agree_with_the_wrappers(cell, span, wrapper, device, monkeypatch):
    result = _traced(cell, device, monkeypatch)
    assert abs(_value(result, span) - _value(result, wrapper)) <= 0.05 * _value(result, wrapper) + 1.0


def test_a_program_without_the_totals_gives_no_reading(monkeypatch):
    """As the parent commit of the spans is: the counters read 0, the
    readers give None, nothing raises."""
    import pyslam_tpu_torch.observability as obs
    import pyslam_tpu_torch.solver.linear as linear

    monkeypatch.delattr(obs, "SPAN_NS")
    monkeypatch.delattr(linear, "LM_TRIALS")
    from portbench.metrics import ell_plan_ms, host_wait_ms, host_work_ms, lm_rejected

    modules = (host_wait_ms, host_work_ms, ell_plan_ms, lm_rejected)
    run = harness.Run({}, {}, {}, 1)
    run.probes = probes.Probes(probes.collect(modules))
    for i in range(2):
        run.probes.begin(i)
        run.probes.end()
        run.solves.append(harness.Solve(0.1, 1.0, "steady"))
    assert all(v == 0 for v in run.probes.counts.values())
    assert [m.read(run) for m in modules] == [None] * 4
