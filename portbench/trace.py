"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read: the device's operations and their union, kernels by name,
and the device's idle gaps with what the host was doing in each.

The profiler keeps its events in memory; nothing is written to disk."""

from __future__ import annotations

import dataclasses
import re
from collections import Counter, defaultdict

import torch

# device operations that are no kernels
_COPIES = ("Memcpy", "Memset")


@dataclasses.dataclass
class Event:
    name: str
    device: bool  # ran on the card
    start: int  # ns
    end: int
    thread: int = 0


def events(prof) -> list:
    """Every event of a finished ``torch.profiler.profile``, but the copies
    of the host's annotations that the profiler lays over the device's
    timeline (they are no device work)."""
    out = []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for e in results.events():
            device = e.device_type() == torch.autograd.DeviceType.CUDA
            if device and e.is_user_annotation():
                continue
            start = e.start_ns()
            out.append(Event(e.name(), device, start, start + e.duration_ns(), e.start_thread_id()))
        return out
    for e in prof.events():  # the older interface: microseconds
        if getattr(e, "is_user_annotation", False) and e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        out.append(Event(e.name, e.device_type == torch.autograd.DeviceType.CUDA, int(1e3 * e.time_range.start),
                         int(1e3 * e.time_range.end), getattr(e, "thread", 0)))
    return out


def union_ns(intervals) -> int:
    """The length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_kernel(e: Event) -> bool:
    return e.device and not e.name.startswith(_COPIES)


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()[:120]


@dataclasses.dataclass
class Summary:
    """The device-profiled part of a window: its host-clock length, the
    device's busy time, every kernel (name, start, end), the device
    operations that took most time, and the longest idle stretches by what
    the host was doing (from the host and device profile)."""

    window_s: float
    busy_s: float
    kernels: list
    device_ops: list
    idle_gaps: list
    solves: int

    def kernel_time_s(self, names) -> float:
        """The union of the intervals of the kernels whose name holds any
        of ``names``."""
        return 1e-9 * union_ns([(s, e) for n, s, e in self.kernels if any(k in n for k in names)])


def summarize(device_events, window_s: float, solves: int, host_events=(), span_prefix: str = "portbench.") -> Summary:
    """``device_events``: a device-only profile of ``solves`` solves that
    took ``window_s`` on the host clock; ``host_events``: a host and device
    profile, whose idle gaps are labelled by what the host was doing."""
    dev = [e for e in device_events if e.device]
    busy = union_ns([(e.start, e.end) for e in dev])
    by_name = defaultdict(int)
    for e in dev:
        by_name[short_name(e.name)] += e.end - e.start
    device_ops = [[n, 1e-9 * t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    kernels = [(e.name, e.start, e.end) for e in dev if is_kernel(e)]
    return Summary(window_s, 1e-9 * busy, kernels, device_ops, idle_gaps(host_events, span_prefix), solves)


def idle_gaps(evts, span_prefix: str = "portbench.") -> list:
    """The stretches between the device's operations, summed by what the
    host thread that launched most was doing at their start: its innermost
    operation, under the benchmark's outermost span; the ten longest."""
    host = [e for e in evts if not e.device]
    merged = _merged([(e.start, e.end) for e in evts if e.device])
    gaps = [(e0, s1 - e0) for (_, e0), (s1, _) in zip(merged, merged[1:])]
    labels = Counter()
    if host and gaps:
        main = Counter(e.thread for e in host).most_common(1)[0][0]
        host = sorted((e for e in host if e.thread == main), key=lambda e: (e.start, -e.end))
        stack, i = [], 0
        for t, length in gaps:
            while i < len(host) and host[i].start <= t:
                while stack and stack[-1].end <= host[i].start:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1].end <= t:
                stack.pop()
            inner = stack[-1].name if stack else "(no host operation)"
            outer = next((e.name[len(span_prefix):] for e in stack if e.name.startswith(span_prefix)), None)
            labels[inner if outer is None else f"{outer}/{inner}"] += length
    return [[n, 1e-9 * t] for n, t in labels.most_common(10)]
