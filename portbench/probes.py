"""Spans, call records and counters that the benchmark puts around calls
into the program's layers, in the traced run only.

A per-layer metric's module names what it reads in ``PROBES``, a list of

* ``Span(name, "module:function")``: the host seconds of each call, summed
  by solve, and a ``torch.profiler.record_function`` named
  ``portbench.<name>`` around it, so that the trace shows the layer;
* ``Call(name, "module:function", count)``: ``count(args, kwargs, result)``
  for each call, a dict of what the call did (bytes, operations), kept
  with the solve it belongs to; ``count`` must not read the device;
* ``Counter(name, read)``: ``read()`` before and after each solve, the
  difference kept with the solve.

The probes wrap the module attribute by which the program calls the
function, and put it back when the run ends.  Nothing in the program is
edited."""

from __future__ import annotations

import dataclasses
import functools
import importlib
import time
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    target: str


@dataclasses.dataclass(frozen=True)
class Call:
    name: str
    target: str
    count: Callable


@dataclasses.dataclass(frozen=True)
class Counter:
    name: str
    read: Callable


def _resolve(target):
    module, attr = target.split(":")
    return importlib.import_module(module), attr


class Probes:
    """The probes of one run: installed around the window, read by solve."""

    def __init__(self, specs):
        self.spans = {s.name: s for s in specs if isinstance(s, Span)}
        self.calls = {s.name: s for s in specs if isinstance(s, Call)}
        self.counters = {s.name: s for s in specs if isinstance(s, Counter)}
        self._saved = []
        self.solve = -1  # the index of the solve running, -1 outside the window
        self.span_s: dict = {}  # (name, solve) -> host seconds
        self.records: dict = {name: [] for name in self.calls}  # name -> [(solve, record)]
        self._before: dict = {}
        self.counts: dict = {}  # (name, solve) -> difference

    def _wrap(self, target, make):
        module, attr = _resolve(target)
        original = getattr(module, attr)
        self._saved.append((module, attr, original))
        setattr(module, attr, functools.wraps(original)(make(original)))

    def install(self):
        for span in self.spans.values():
            def make(original, name=span.name):
                def timed(*args, **kwargs):
                    t0 = time.perf_counter()
                    with torch.profiler.record_function(f"portbench.{name}"):
                        out = original(*args, **kwargs)
                    key = (name, self.solve)
                    self.span_s[key] = self.span_s.get(key, 0.0) + time.perf_counter() - t0
                    return out
                return timed
            self._wrap(span.target, make)
        for call in self.calls.values():
            def make(original, call=call):
                def counted(*args, **kwargs):
                    out = original(*args, **kwargs)
                    record = call.count(args, kwargs, out)
                    if record is not None:
                        self.records[call.name].append((self.solve, record))
                    return out
                return counted
            self._wrap(call.target, make)

    def uninstall(self):
        while self._saved:
            module, attr, original = self._saved.pop()
            setattr(module, attr, original)

    def begin(self, solve):
        self.solve = solve
        self._before = {name: c.read() for name, c in self.counters.items()}

    def end(self):
        for name, c in self.counters.items():
            self.counts[(name, self.solve)] = c.read() - self._before[name]
        self.solve = -1


def collect(metric_modules) -> list:
    """Every probe the metrics name, each name once."""
    seen, out = set(), []
    for module in metric_modules:
        for spec in getattr(module, "PROBES", ()):
            if spec.name not in seen:
                seen.add(spec.name)
                out.append(spec)
    return out
