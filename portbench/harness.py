"""One run of one cell: the configuration's problem made from the seed,
the program's set-up, a closed loop of solves for the window, the traced
part where asked, and the judgement of the answers against the plain
reference.

Everything that belongs to a configuration, a traffic mix or a metric is
found by name: ``configs/<config>.json`` names its generator
(``generators/``), its entry into the program (``entries/``) and its
reference (``references/``); ``traffic/<traffic>.json`` holds the loop's
parameters; ``metrics/<metric>.py`` reads one metric from the run, and
reads ``<metric>.<tag>`` too."""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import pathlib
import random
import statistics
import time

import torch

from . import judge, probes as _probes, trace as _trace
from .arith import Arith

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_of(manifest: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic_of(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def metrics_for(manifest: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: the end-to-end ones untraced,
    the per-layer ones traced.  An entry with ``workloads`` goes to the
    cells it lists; an end-to-end one without goes to every cell, and a
    per-layer one without to every cell that reports the metric it moves."""
    ends = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return ends
    moved = {m["name"] for m in ends}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved)]


def reader_name(name: str) -> str:
    """The reader of a metric: its name up to the first dot, so that a cell
    on an existing path appends ``linearize_ms.<tag>``, listing itself, and
    ``metrics/linearize_ms.py`` reads it."""
    return name.split(".")[0]


def reader(name: str):
    return importlib.import_module(f"portbench.metrics.{reader_name(name)}")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Solve:
    seconds: float
    chi2: float
    phase: str  # "steady", or "device" / "host" under a profile


@dataclasses.dataclass
class Run:
    """What one run measured, for the metric readers, beside the cell, its
    configuration and traffic, and the seed."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    setup_s: float = 0.0
    plan_s: float = 0.0
    window_s: float = 0.0
    solves: list = dataclasses.field(default_factory=list)
    probes: object = None
    summary: object = None

    def steady(self) -> list:
        """The window's solves that no profile slowed."""
        return [i for i, s in enumerate(self.solves) if s.phase == "steady"]

    def span_ms(self, name):
        """Host ms a steady solve spends in the span, or None."""
        if self.probes is None or name not in self.probes.spans:
            return None
        vals = [self.probes.span_s.get((name, i), 0.0) for i in self.steady()]
        total = sum(vals)
        return 1e3 * total / len(vals) if vals and total > 0 else None

    def records(self, name, profiled_only=False):
        if self.probes is None or name not in self.probes.records:
            return []
        return [r for i, r in self.probes.records[name]
                if i >= 0 and (not profiled_only or self.solves[i].phase == "device")]

    def per_solve(self, name, value):
        """The mean over the window's solves of value(record) summed by
        solve, or None where the call was never made."""
        if self.probes is None or not self.records(name):
            return None
        sums = [0.0] * len(self.solves)
        for i, r in self.probes.records[name]:
            if i >= 0:
                sums[i] += value(r)
        return sum(sums) / len(sums)

    def roofline_pct(self, name, kernels, bound):
        """100 x the bound of the calls in the device-profiled solves over
        the union of their kernels' time, or None where either is missing."""
        if self.summary is None:
            return None
        recs = self.records(name, profiled_only=True)
        t = self.summary.kernel_time_s(kernels)
        if not recs or t <= 0:
            return None
        return 100.0 * sum(bound(r) for r in recs) / t


def _keep(sample: list, k: int, n: int, answer: dict, rng: random.Random):
    """Reservoir sampling: after n answers, ``sample`` holds k drawn
    uniformly from them."""
    if len(sample) < k:
        sample.append(answer)
    else:
        j = rng.randrange(n)
        if j < k:
            sample[j] = answer


def run_cell(manifest: dict, cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, config: dict | None = None) -> dict:
    """One run; returns the result line's object.  ``config`` replaces the
    configuration's file (the tests' small sizes)."""
    cell = cell_of(manifest, cell_name)
    cfg = config if config is not None else config_of(manifest, cell["config"])
    traffic = traffic_of(cell["traffic"])
    gen = importlib.import_module(f"portbench.generators.{cfg['generator']}")
    entry = importlib.import_module(f"portbench.entries.{cfg['entry']}")
    ref = importlib.import_module(f"portbench.references.{cfg['reference']}")
    import pyslam_tpu_torch  # noqa: F401  the program under test

    cuda = torch.device(device).type == "cuda"
    run = Run(cell, cfg, traffic, seed)
    marks = [("imports", time.perf_counter())]
    build = {}
    if cuda:
        from pyslam_tpu_torch import _ext

        torch.zeros(1, device=device)
        _sync(device)
        marks.append(("context", time.perf_counter()))
        # the kernel library, built here in a checkout's first run
        _ext.library()
        build = dict(seconds=_ext.BUILD_INFO["seconds"], cached=_ext.BUILD_INFO["cached"])
        marks.append(("kernels", time.perf_counter()))
    problem = gen.generate(cfg["sizes"], seed, device)
    _sync(device)
    marks.append(("problem", time.perf_counter()))
    state = entry.build(problem, cfg, device)
    _sync(device)
    marks.append(("graph", time.perf_counter()))
    entry.plan(state)
    _sync(device)
    marks.append(("plan", time.perf_counter()))
    run.plan_s = marks[-1][1] - marks[-2][1]
    # the generator's float64 arrays wait on the host, so that the peak below
    # is the program's
    problem = {k: v.cpu() if torch.is_tensor(v) else v for k, v in problem.items()}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(int(traffic["warmup_solves"])):
        entry.restore(state)
        entry.solve(state)
        _sync(device)
    marks.append(("warmup", time.perf_counter()))

    wanted = metrics_for(manifest, cell_name, trace)
    modules = {m["name"]: reader(m["name"]) for m in wanted}
    if trace:
        run.probes = _probes.Probes(_probes.collect(modules.values()))
        run.probes.install()
    rng = random.Random(seed)
    sample, failed = [], 0
    # the traced run's phases, in order: solves with the probes alone (the
    # spans and counters), then solves under a device-only profile (busy
    # time, kernels, rooflines), then one solve under a host and device
    # profile (what the host did in the device's idle gaps); the profiles
    # slow the host, so the spans are read before either has run
    phases = [("steady", seconds)]
    if trace:
        phases = [("steady", float(traffic["steady_share"]) * seconds), ("device", float(traffic["profile_seconds"])),
                  ("host", 0.0)]
    device_events, host_events, profiled_s, profiled_n = [], [], 0.0, 0
    try:
        w0 = time.perf_counter()
        run.setup_s = w0 - t_start
        for phase, length in phases:
            prof = None
            if phase != "steady":
                kinds = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
                if phase == "host" or not cuda:
                    kinds.append(torch.profiler.ProfilerActivity.CPU)
                prof = torch.profiler.profile(activities=kinds)
                prof.__enter__()
            p0 = time.perf_counter()
            while True:
                s0 = time.perf_counter()
                if run.probes is not None:
                    run.probes.begin(len(run.solves))
                entry.restore(state)
                answer = entry.solve(state)
                _sync(device)
                if run.probes is not None:
                    run.probes.end()
                s1 = time.perf_counter()
                run.solves.append(Solve(s1 - s0, answer["chi2"], phase))
                failed += not math.isfinite(answer["chi2"])
                _keep(sample, int(traffic["judge_answers"]), len(run.solves), answer, rng)
                if s1 - p0 >= length:
                    break
            if prof is not None:
                prof.__exit__(None, None, None)
                if phase == "device":
                    device_events = _trace.events(prof)
                    profiled_s, profiled_n = s1 - p0, sum(x.phase == "device" for x in run.solves)
                else:
                    host_events = _trace.events(prof)
        run.window_s = s1 - w0
    finally:
        if run.probes is not None:
            run.probes.uninstall()
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        run.summary = _trace.summarize(device_events, profiled_s, profiled_n, host_events)

    metrics = {}
    for m in wanted:
        value = modules[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])

    # the program's state goes before the reference runs, so that the peak
    # above is the program's and the reference has the card
    del state
    if run.probes is not None:
        run.probes.records.clear()
    if cuda:
        torch.cuda.empty_cache()
    problem = {k: v.to(device) if torch.is_tensor(v) else v for k, v in problem.items()}
    marks.append(("window", time.perf_counter()))
    against = judge.reference_answer(ref, problem, cfg, Arith())
    marks.append(("reference", time.perf_counter()))
    readings = [judge.numbers(ref, problem, a, against) for a in sample]
    marks.append(("judge", time.perf_counter()))
    worst = judge.worst_of(readings)
    correct = failed == 0 and judge.verdict(worst, cfg["limits"])

    result = dict(
        correct=bool(correct), attempted=len(run.solves), failed=failed, metrics=metrics,
        device=dict(platform="gpu" if cuda else "cpu", kind=torch.cuda.get_device_name(device) if cuda else "cpu",
                    count=1, memory_peak_bytes=int(memory_peak)),
    )
    if trace:
        result["device"].update(busy_s=run.summary.busy_s, window_s=run.summary.window_s)
        result["breakdown"] = dict(device_ops=run.summary.device_ops, idle_gaps=run.summary.idle_gaps)
    # the seconds of each stage of the run, the first from the process's start;
    # setup_s holds every stage up to the warm-up, the kernels' build with them
    result["stages_s"] = {name: t - (marks[i - 1][1] if i else t_start) for i, (name, t) in enumerate(marks)}
    result["kernel_build"] = build
    q = statistics.quantiles([x.seconds for x in run.solves], n=4) if len(run.solves) > 1 else [run.solves[0].seconds] * 3
    result["solve_ms_quartiles"] = [1e3 * v for v in q]
    chi2s = [s.chi2 for s in run.solves]
    result["reference"] = dict(chi2=against["chi2"], lm_iterations=against["iterations"], answers_judged=len(readings),
                               window_chi2_spread=(max(chi2s) - min(chi2s)) / abs(statistics.median(chi2s)))
    # last: every number compared, beside its limit
    result["checks"] = {k: dict(value=worst[k], limit=cfg["limits"][k]) for k in judge.NUMBERS}
    return result
