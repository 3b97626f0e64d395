"""Observability and checkpointing: per-iteration JSONL solve logs,
profiling helpers, the solvers' spans and solver-state snapshot / resume.

Counterpart of ``pyslam_tpu/observability.py``:

  * iteration logs come after the solve from the per-iteration tensors
    that ``lm.solve`` records (``SolveInfo``), read once;
  * ``profile_trace`` is ``torch.profiler`` (CPU and, where there is one,
    the CUDA device) writing a Chrome trace into ``logdir``, in place of
    ``jax.profiler``;
  * ``span`` marks a layer of the solvers: host nanoseconds and calls by
    name (``SPAN_NS``, ``SPAN_CALLS``), and a ``record_function`` range in
    the profiler's timeline while a profiler runs.  The reference's
    ``timed`` has no counterpart: it timed the enqueue, not the work;
  * checkpoints write the leaves of a tree of dicts, lists, tuples,
    tensors and the graph dataclasses (``VariableBlock``, ``FactorBatch``,
    ``FactorGraph``) with ``np.savez`` in the reference's layout:
    ``leaf_<i>`` in the reference's leaf order (dict keys sorted,
    dataclass fields in order) and a ``__treedef__`` description.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import time

import numpy as np
import torch


# --------------------------------------------------------------------------
# Iteration logging
# --------------------------------------------------------------------------


def iteration_records(info) -> list[dict]:
    """Expand a solver SolveInfo into one dict per executed iteration."""
    n = int(info.iterations)
    cost, lam, dx, acc = (t.detach().cpu().numpy()
                          for t in (info.cost_history, info.lambda_history, info.update_norms, info.accepted))
    return [
        {
            "iter": it,
            "cost_before": float(cost[it]),
            "cost_after": float(cost[it + 1]),
            "lambda": float(lam[it]),
            "update_norm": float(dx[it]),
            "accepted": bool(acc[it]),
        }
        for it in range(n)
    ]


def write_iteration_log(info, path: str, extra: dict | None = None) -> None:
    """JSONL per-iteration solve log (chi2, lambda, |dx|, accepted) plus a
    final summary line."""
    with open(path, "w") as f:
        for rec in iteration_records(info):
            if extra:
                rec.update(extra)
            f.write(json.dumps(rec) + "\n")
        f.write(
            json.dumps(
                {"summary": True, "chi2": float(info.chi2), "iterations": int(info.iterations), "status": int(info.status)}
            )
            + "\n"
        )


# --------------------------------------------------------------------------
# Profiling
# --------------------------------------------------------------------------


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write a Chrome trace, ``trace.json``, into ``logdir``
    (viewable in Perfetto or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# Host nanoseconds and calls of each span name since ``reset_spans``, summed
# at the outermost span of a name: a span nested in one of the same name
# (``lm.solve`` under ``solve_ell``) adds nothing.  Read by callers that
# account for them, as ``linear.HOST_READS`` is.
SPAN_NS: dict = {}
SPAN_CALLS: dict = {}
_DEPTH: dict = {}  # name -> spans of that name open now


def reset_spans():
    SPAN_NS.clear()
    SPAN_CALLS.clear()


class span(contextlib.ContextDecorator):
    """``with span(name):`` or ``@span(name)``: the block's host time on
    ``time.perf_counter_ns`` into ``SPAN_NS[name]`` and one call into
    ``SPAN_CALLS[name]``.  While a ``torch.profiler`` runs, the outermost
    span of a name is also a ``record_function`` range, on the clock of the
    device's events; without one it enters none (a range costs several µs
    an entry, the check tens of ns).  Host time: the device's work shows
    only where the host waits for it inside the span."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0
        self._range = None

    def __enter__(self):
        depth = _DEPTH.get(self.name, 0)
        _DEPTH[self.name] = depth + 1
        if depth == 0:
            if torch.autograd.profiler._is_profiler_enabled:
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        depth = _DEPTH[self.name] - 1
        _DEPTH[self.name] = depth
        if depth == 0:
            SPAN_NS[self.name] = SPAN_NS.get(self.name, 0) + time.perf_counter_ns() - self._t0
            SPAN_CALLS[self.name] = SPAN_CALLS.get(self.name, 0) + 1
            if self._range is not None:
                rng, self._range = self._range, None
                rng.__exit__(*exc)
        return False


# --------------------------------------------------------------------------
# Checkpoint / resume
# --------------------------------------------------------------------------


def _is_leaf(x):
    return torch.is_tensor(x) or isinstance(x, (np.ndarray, np.generic, bool, int, float))


def _map_leaves(tree, fn):
    """``tree`` rebuilt with ``fn`` applied to each leaf, in leaf order: dict
    values by sorted key, list and tuple elements, dataclass fields in
    declaration order (the reference's order for the graph dataclasses);
    strings, None and other objects are structure, not leaves."""
    if _is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        new = {k: _map_leaves(tree[k], fn) for k in sorted(tree, key=repr)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [_map_leaves(x, fn) for x in tree]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        new = {f.name: _map_leaves(getattr(tree, f.name), fn) for f in dataclasses.fields(tree)}
        return dataclasses.replace(tree, **new)
    return tree


def _describe(tree) -> str:
    return repr(_map_leaves(tree, lambda x: "*"))


def save_state(path: str, tree) -> None:
    """Snapshot a tree of tensors (solver state, graph values, a whole
    FactorGraph) into an npz file, one array per leaf."""
    leaves = []
    _map_leaves(tree, lambda x: leaves.append(x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)))
    np.savez(
        path,
        __treedef__=np.frombuffer(_describe(tree).encode(), dtype=np.uint8),
        **{f"leaf_{i}": x for i, x in enumerate(leaves)},
    )


def load_state(path: str, like):
    """Restore a tree saved by ``save_state``; ``like`` supplies the
    structure (checkpoints are value snapshots, not schema migrations).  A
    leaf comes back as its counterpart in ``like`` is: a tensor in its
    dtype on its device, a numpy array, or a Python number."""
    count = itertools.count()

    def restore(ref):
        arr = data[f"leaf_{next(count)}"]
        if torch.is_tensor(ref):
            return torch.as_tensor(arr, dtype=ref.dtype).to(ref.device)
        if isinstance(ref, (np.ndarray, np.generic)):
            return arr
        return type(ref)(arr)

    with np.load(path) as data:
        return _map_leaves(like, restore)


def graph_checkpoint(graph) -> dict:
    """Minimal resumable state of a FactorGraph: the variable values (host
    numpy)."""
    return {name: b.values.detach().cpu().numpy() for name, b in graph.blocks.items()}


def graph_restore(graph, ckpt: dict):
    """Rebuild a FactorGraph with checkpointed variable values, on the
    graph's device and in its dtype."""
    from .graph.core import FactorGraph, VariableBlock

    blocks = {
        name: VariableBlock(b.kind, torch.as_tensor(np.asarray(ckpt[name]), dtype=b.values.dtype).to(b.values.device),
                            b.const_mask)
        for name, b in graph.blocks.items()
    }
    return FactorGraph(blocks, graph.batches)


__all__ = [
    "iteration_records",
    "write_iteration_log",
    "profile_trace",
    "span",
    "SPAN_NS",
    "SPAN_CALLS",
    "reset_spans",
    "save_state",
    "load_state",
    "graph_checkpoint",
    "graph_restore",
]
