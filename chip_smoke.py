#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``pyslam_tpu_torch``) on one
NVIDIA GPU: builds its CUDA kernels, checks each against its plain PyTorch
version at the main path's shapes, and drives the main path — the
sphere2500 SE(3) pose-graph LM solve through ``build.pose_graph`` and
``bcsr.solve_ell`` — checking that it reaches the converged cost and went
through the kernels.

Run from the repository root, with no arguments, on a machine with a
CUDA device and ``nvcc``:

    python3 chip_smoke.py

Every phase raises on failure and the script then exits non-zero.  The
second-to-last line of standard output is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.  The script
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

N_POSES = 2500
SEED = 0
TIMING_CALLS = 50
# Relative tolerances of a kernel against its plain version: both sum the
# same terms in another order, so the difference is rounding only.
REL_TOL = {"float32": 1e-5, "float64": 1e-12}


def log(msg=""):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, args, calls=TIMING_CALLS):
    """Device time of one call: the median over ``calls`` calls, each timed
    with a pair of CUDA events.  Before each call the stream is held busy
    for about 0.5 ms (``torch.cuda._sleep``), so the host has queued the
    whole call before the first event fires and the pair measures the
    device's work, not the host's launch overhead."""
    import torch

    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    # ---- phase 1: device -------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no GPU to run on")
    import pyslam_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from pyslam_tpu_torch import _ext
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import cuda_ops, linear
    from pyslam_tpu_torch.solver.bcsr import (
        assemble_ell,
        build_ell_direct,
        ell_contributions,
        ell_device_plan,
        solve_ell,
    )
    from pyslam_tpu_torch.solver.lm import STATUS_NAMES, Options

    with open(os.path.join(ROOT, "bench", "baseline_cache.json")) as f:
        chi2_ref = float(json.load(f)["chi2"])

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "not available"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")

    # ---- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    _ext.library()
    built = _ext.BUILD_INFO
    log(f"build: {time.perf_counter() - t0!r} s (nvcc {built['seconds']!r} s, cached {built['cached']}) {built['path']}")
    for line in built.get("log", "").splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas {line.strip()}")

    # ---- phase 3: kernels vs plain versions at main-path shapes ------------
    data = synth.se3_sphere(n_poses=N_POSES, seed=SEED)
    graph = build.pose_graph(data, dtype=torch.float32, device=dev)
    plan = build_ell_direct(graph)
    dplan = ell_device_plan(plan, dev)
    nb, d, K = plan.nb, plan.d, plan.K
    h_contrib, g_contrib, _ = ell_contributions(graph, plan)
    He, _, _ = assemble_ell(graph, dplan)
    x = torch.from_numpy(np.random.default_rng(SEED).normal(size=nb * d)).to(dev, torch.float32)
    torch.cuda.synchronize()
    log(
        f"shapes: nb={nb} K={K} d={d} edges={graph.batches[0].n} He={tuple(He.shape)} "
        f"h_contrib={tuple(h_contrib.shape)} g_contrib={tuple(g_contrib.shape)}"
    )
    cases = [
        ("ell_matvec", cuda_ops.ell_matvec, cuda_ops.ell_matvec_plain, [He, dplan.cols, x]),
        ("slot_reduce", cuda_ops.slot_reduce, cuda_ops.slot_reduce_plain,
         [h_contrib, dplan.h_perm, dplan.h_offsets, nb * K]),
        ("slot_reduce", cuda_ops.slot_reduce, cuda_ops.slot_reduce_plain,
         [g_contrib, dplan.g_perm, dplan.g_offsets, nb]),
    ]
    report = {}
    for name, fn, plain, args in cases:
        for dtype in (torch.float32, torch.float64):
            a = [t.to(dtype) if torch.is_tensor(t) and t.is_floating_point() else t for t in args]
            out = fn(*a)
            ref = plain(*a)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            tname = str(dtype).split(".")[-1]
            log(f"{name} {tname} out{tuple(out.shape)}: max_abs_err {err!r} max|ref| {scale!r} rel {err / scale!r}")
            check(torch.isfinite(out).all().item(), f"{name} {tname}: non-finite output")
            check(err <= REL_TOL[tname] * scale, f"{name} {tname}: error {err} > {REL_TOL[tname]} * {scale}")
            if dtype is torch.float32:
                r = report.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0))
                r["max_abs_err"] = max(r["max_abs_err"], err)
        ms = median_ms(fn, args)
        plain_ms = median_ms(plain, args)
        log(f"{name} f32 out{tuple(fn(*args).shape)}: device time per call: kernel {ms!r} ms, "
            f"plain {plain_ms!r} ms (median of {TIMING_CALLS})")
        report[name]["ms"] += ms
        report[name]["plain_ms"] += plain_ms
    torch.cuda.synchronize()

    # ---- phase 4: the main path --------------------------------------------
    opts = Options(method="lm", max_iters=30, min_cost_decrease=0.999)

    def run():
        solved, info = solve_ell(graph, opts, plan=plan, pcg_rtol=3e-6, pcg_max_iters=120)
        torch.cuda.synchronize()
        return solved, info, info.chi2.item()

    t0 = time.perf_counter()
    run()  # warm-up
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    linear.reset_host_reads()
    t0 = time.perf_counter()
    solved, info, chi2 = run()
    wall = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    reads = dict(linear.HOST_READS)
    peak = torch.cuda.max_memory_allocated()
    cg_iters = launches["ell_matvec"] - info.iterations  # one r0 matvec per linear solve
    log(
        f"solve sphere2500 f32: wall {wall!r} s (warm-up {warm!r} s), LM iterations {info.iterations}, "
        f"status {STATUS_NAMES[info.status]!r}, chi2 {chi2!r} (gate {1.001 * chi2_ref!r}), "
        f"CG iterations {cg_iters}, host reads {reads}, launches {launches}, peak memory {peak} B"
    )
    check(chi2 <= 1.001 * chi2_ref, f"chi2 {chi2} above 1.001 x {chi2_ref}")
    poses = solved.blocks["poses"].values
    check(tuple(poses.shape) == (N_POSES, 4, 4), f"poses shape {tuple(poses.shape)}")
    check(torch.isfinite(poses).all().item(), "non-finite poses")
    for k in ("ell_matvec", "slot_reduce"):
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")
        check(launches[f"{k}_plain"] == 0, f"plain {k} ran on the main path")

    # ---- phase 5: the kernels' path agrees with the CPU path ---------------
    small = synth.se3_sphere(n_poses=60, seed=11)
    res = {}
    for where in ("cpu", "cuda"):
        g_small = build.pose_graph(small, dtype=torch.float64, device=where)
        s_small, i_small = solve_ell(g_small, Options(method="lm", max_iters=20))
        res[where] = (i_small.iterations, i_small.status, i_small.chi2.item(),
                      s_small.blocks["poses"].values.cpu())
    (it_c, st_c, c_c, p_c), (it_g, st_g, c_g, p_g) = res["cpu"], res["cuda"]
    pose_err = (p_c - p_g).abs().max().item()
    log(f"small f64 se3_sphere(60): cpu {it_c} it chi2 {c_c!r}; cuda {it_g} it chi2 {c_g!r}; pose diff {pose_err!r}")
    check((it_c, st_c) == (it_g, st_g), "CPU and CUDA paths took different iterations or stop codes")
    check(abs(c_c - c_g) <= 1e-8 * abs(c_c), "CPU and CUDA chi2 differ by more than 1e-8 rel")
    check(pose_err <= 1e-6, "CPU and CUDA poses differ by more than 1e-6")

    sources = {"ell_matvec": "pyslam_tpu_torch/csrc/ell_matvec.cu",
               "slot_reduce": "pyslam_tpu_torch/csrc/slot_reduce.cu"}
    replaces = {"ell_matvec": "pyslam_tpu/solver/pallas_ops.py:60",
                "slot_reduce": "pyslam_tpu/solver/pallas_ops.py:143"}
    kernels = [
        dict(name=k, route="cuda", source=sources[k], replaces=replaces[k], launches=launches[k], **v)
        for k, v in report.items()
    ]
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
