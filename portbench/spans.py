"""What the per-layer metrics read of the program's own accounting: the host
nanoseconds of its spans by name (``pyslam_tpu_torch.observability.SPAN_NS``)
and its LM trials by accept decision (``pyslam_tpu_torch.solver.linear.
LM_TRIALS``), each total read through a ``Counter`` probe before and after
every solve.  A program that keeps no such total gives no reading, and the
metric is left out of the result line."""

from __future__ import annotations

import importlib

from portbench.probes import Counter

_SPANS = ("pyslam_tpu_torch.observability", "SPAN_NS")
_TRIALS = ("pyslam_tpu_torch.solver.linear", "LM_TRIALS")


def _totals(where):
    module, attr = where
    return getattr(importlib.import_module(module), attr, None)


def _counter(where, key):
    def read():
        totals = _totals(where)
        return 0 if totals is None else totals.get(key, 0)

    return Counter(f"{where[1]}.{key}", read)


def span_ns(name: str) -> Counter:
    return _counter(_SPANS, name)


def trials(kind: str) -> Counter:
    return _counter(_TRIALS, kind)


def steady_ms(run, plus: str, minus: str | None = None):
    """Host ms a steady solve spent in span ``plus``, less its time in span
    ``minus`` (nested in ``plus``), averaged over the solves no profile
    slowed; None where the program keeps no spans or ``plus`` never ran."""
    if run.probes is None or _totals(_SPANS) is None:
        return None

    def ns(name, i):
        return run.probes.counts.get((span_ns(name).name, i), 0) if name else 0

    steady = run.steady()
    if not any(ns(plus, i) for i in steady):
        return None
    return 1e-6 * sum(ns(plus, i) - ns(minus, i) for i in steady) / len(steady)


def per_solve_trials(run, kind: str):
    """LM trials of ``kind`` a solve, over every solve of the window; None
    where the program does not count them."""
    if run.probes is None or _totals(_TRIALS) is None:
        return None
    name = trials(kind).name
    return sum(run.probes.counts.get((name, i), 0) for i in range(len(run.solves))) / len(run.solves)
