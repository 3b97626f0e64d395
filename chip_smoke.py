#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``pyslam_tpu_torch``) on one
NVIDIA GPU: builds its CUDA kernels, checks each against its plain PyTorch
version at the shapes its paths give it, times kernel, plain version and
(where one PyTorch call computes the same function) that library call, and
drives each ported path through the entry points a user calls, checking
that it reaches its converged cost and went through the kernels:

  * sphere2500 (SE(3), ``build.pose_graph`` + ``bcsr.solve_ell``), LM, gate
    chi2 <= 1.001 x ``bench/baseline_cache.json``: one ``ell_assemble``
    launch per assembly, one ``ell_pcg`` launch per linear solve and no CG
    stop test read by the host;
  * sphere2500 by dogleg on the same path, whose model products are the
    stand-alone ``ell_matvec`` kernel;
  * bench config 1, ``se2_loop(100)`` + Cauchy, dense LM;
  * bench config 2, ``se2_manhattan(3500)`` through the g2o writer and
    reader, dense GN (D = 10,500);
  * bench config 7, ``sim3_loop(400)``, dense LM;
    each of the last three with the 1% gate of ``bench/run.py`` on the
    converged cost in ``bench/standin_cache.json``;
  * small f64 cross-checks of the card's path against the CPU path.

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
# Launches between one pair of events when a small kernel is timed.
BACK_TO_BACK = 20
# Peaks of one NVIDIA H100 SXM (data sheet, 700 W): device memory rate and
# float32 rate outside the tensor cores.  A kernel's bound is the larger of
# its bytes (each input read once, each output written once) over the
# first and its operations over the second.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12
# The 1% gates of bench/run.py on the converged costs of the stand-in
# solvers, by the keys of bench/standin_cache.json.
STANDIN_GATE = 1.01
KERNELS = ("ell_matvec", "ell_pcg", "slot_reduce", "ell_assemble")
# Relative tolerances of a kernel against its plain version: both sum the
# same terms in another order, so the difference is rounding only.
REL_TOL = {"float32": 1e-5, "float64": 1e-12}
# ell_assemble against its plain version: twice REL_TOL in f32 and ten times
# in f64.  The kernel contracts its multiply-adds and evaluates sin, cos and
# atan2 with other code than the batched tensor ops; a Jacobian entry differs
# by a few roundings of its largest term, and He sums products of two.
ASSEMBLE_TOL = {"float32": 2e-5, "float64": 1e-11}
# Floating-point operations of one ell_assemble call, counted from its
# source: stage 1 a factor (nine 3x3 products for Q, five more, two rigid
# compositions, six rows of Jacobians and loss), stage 2 a 6x6 contribution
# (36 sums of six w * J * J terms) and a gradient row (six sums of six).
ASSEMBLE_FLOP = {"factor": 1700, "contribution": 648, "gradient_row": 72}


def log(msg=""):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, args, calls=TIMING_CALLS, inner=1):
    """Device time of one call: the median over ``calls`` measurements, each
    a pair of CUDA events around ``inner`` calls, divided by ``inner``.
    Before each measurement the stream is held busy (``torch.cuda._sleep``)
    for at least 0.5 ms and three times as long as the host took to queue
    the calls in the warm-up, so the host has queued them all before the
    first event fires and the pair measures the device's work, not the
    host's launch overhead.  With ``inner`` = 1 the pair's own cost (a few
    microseconds) is part of the figure; ``inner`` > 1 runs the calls back
    to back and spreads it."""
    import torch

    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn(*args)
    queue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = max(1_000_000, int(3 * queue_s * 2e9))  # the SM clock is just under 2 GHz
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(inner):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(n_bytes, flop):
    """(least time in ms the card could take, what bounds it)."""
    by_bytes, by_ops = 1e3 * n_bytes / H100_BYTES_PER_S, 1e3 * flop / H100_F32_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def host_ms(fn, reps=5):
    """Host wall time of one call, ending in a synchronise: the median
    over ``reps`` calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def add_times(report, name, key, times, n_bytes, flop):
    """Accumulate one timed call into ``report[name]``: ``times`` maps
    "ms", "single_ms", "plain_ms", "library_ms" to this call's figures; the
    call's bound is computed from its bytes and operations.  ``key`` is
    "ms" for a sphere2500 call (the kernels line's columns) or
    "<config>_ms" for a dense-assembly shape."""
    import math

    r = report[name]
    b_ms, by = bound_ms(n_bytes, flop)
    prefix = key[: -len("ms")]
    for k, v in {**times, "bound_ms": b_ms}.items():
        if v is not None:
            r[prefix + k] = r.get(prefix + k, 0.0) + v
    r.setdefault(prefix + "library_ms", None)
    r[prefix + "bound_by"] = by
    log(f"{name} {key[:-3] or 'sphere2500'}: {times}; bound {b_ms!r} ms by {by} "
        f"({n_bytes} B, {flop} flop); kernel / bound {times['ms'] / b_ms if b_ms else math.inf!r}")


def check_kernel(name, fn, plain, args, report, key, flop, library=None):
    """``fn`` against ``plain`` on the same inputs in f32 and f64, then the
    device time of each in f32, and of ``library`` (one PyTorch call on the
    same inputs, prepared outside the timing) where there is one."""
    import torch

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
        r = report.setdefault(name, dict(max_abs_err=0.0))
        if dtype is torch.float32:
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if library is not None:
                lib_err = (library() - ref).abs().max().item()
                check(lib_err <= REL_TOL[tname] * scale, f"{name}: the library call disagrees by {lib_err}")
    times = dict(
        ms=median_ms(fn, args, inner=BACK_TO_BACK),
        single_ms=median_ms(fn, args),
        plain_ms=median_ms(plain, args),
        library_ms=median_ms(library, (), inner=BACK_TO_BACK) if library is not None else None,
    )
    tensors = [t for t in args if torch.is_tensor(t)]
    add_times(report, name, key, times, tensor_bytes(*tensors, fn(*args)), flop)


def check_pcg(He, cols, g, rtol, max_iters, report):
    """``ell_pcg`` against ``ell_pcg_plain`` on one damped sphere2500
    system (block-Jacobi inverse from ``sym_block_inv``, as ``solve_ell``
    makes it), in f32 and f64, and the device time of each in f32.

    Tolerances.  f64: the same iteration count, x within 1e-9 of its
    largest entry (the kernel's dot products sum in another order, 1e-16 a
    step, over at most ``max_iters`` dependent steps).  f32: the count
    within one iteration where the run stops on its tolerance (the stop
    test compares two f32 norms computed in different orders), equal where
    it stops on the cap; x within 1e-4 of its largest entry (rounding of
    1e-7 a step grows over 120 dependent steps of an ill-conditioned
    system), and the kernel's true residual within 1% of the plain
    version's."""
    import torch

    from pyslam_tpu_torch.solver import cuda_ops, linear
    from pyslam_tpu_torch.solver.bcsr import sym_block_inv

    for dtype, x_tol in ((torch.float32, 1e-4), (torch.float64, 1e-9)):
        a = [He.to(dtype), cols, sym_block_inv(He.to(dtype)[:, 0]).contiguous(), g.to(dtype)]
        linear.reset_host_reads()
        out = cuda_ops.ell_pcg(*a, rtol, max_iters)
        torch.cuda.synchronize()
        check(linear.HOST_READS["pcg"] == 0, "ell_pcg read a stop test on the host")
        again = cuda_ops.ell_pcg(*a, rtol, max_iters)
        ref = cuda_ops.ell_pcg_plain(*a, rtol, max_iters)
        it, it_ref = int(out.iterations), int(ref.iterations)
        err = (out.x - ref.x).abs().max().item()
        scale = ref.x.abs().max().item()

        def residual(x):
            return (torch.linalg.norm(a[3] - cuda_ops.ell_matvec_plain(a[0], cols, x)) / torch.linalg.norm(a[3])).item()

        res, res_ref = residual(out.x), residual(ref.x)
        tname = str(dtype).split(".")[-1]
        log(f"ell_pcg {tname}: iterations {it} (plain {it_ref}, cap {max_iters}), resident rows {out.resident_rows} of "
            f"{He.shape[0]}, max_abs_err {err!r} max|ref| {scale!r} rel {err / scale!r}, "
            f"true residual {res!r} (plain {res_ref!r})")
        check(torch.isfinite(out.x).all().item(), f"ell_pcg {tname}: non-finite output")
        check(torch.equal(out.x, again.x) and it == int(again.iterations), f"ell_pcg {tname}: two runs differ")
        slack = 0 if dtype is torch.float64 or it_ref == max_iters else 1
        check(abs(it - it_ref) <= slack, f"ell_pcg {tname}: {it} iterations, plain {it_ref}")
        check(err <= x_tol * scale, f"ell_pcg {tname}: error {err} > {x_tol} * {scale}")
        check(res <= 1.01 * res_ref, f"ell_pcg {tname}: true residual {res} above the plain version's {res_ref}")
        check(out.resident_rows == He.shape[0], "ell_pcg: sphere2500 should be resident in shared memory")
        nb, K, d, _ = He.shape
        log(f"ell_pcg {tname}: launch plan {cuda_ops.ell_pcg_plan(nb, K, d, dtype, He.device)}")
        if dtype is torch.float32:
            report["ell_pcg"] = dict(max_abs_err=err)
            # per iteration: the ELL product and the block-Jacobi product (2
            # flop a stored value), three dot products, three vector updates
            flop = it * (2 * nb * (K + 1) * d * d + 12 * nb * d)
            args = (*a, rtol, max_iters)
            ms = median_ms(lambda *b: cuda_ops.ell_pcg(*b), args)
            times = dict(ms=ms, single_ms=ms, plain_ms=median_ms(cuda_ops.ell_pcg_plain, args, calls=5),
                         library_ms=None)
            add_times(report, "ell_pcg", "ms", times, tensor_bytes(*a, out.x), flop)
            log(f"ell_pcg f32: {1e3 * ms / max(it, 1)!r} us per CG iteration")


def check_assemble(label, graph, report=None):
    """``ell_assemble`` against ``ell_assemble_plain`` on ``graph`` in its
    dtype: He, g and chi2 within ``ASSEMBLE_TOL`` of their largest entries,
    two runs bitwise equal, and ``assemble_ell`` dispatching to the kernel.
    With ``report``, also the device times of the kernel, its plain version
    and the general route it replaces (plain-tensor linearization and two
    ``slot_reduce``) beside the kernel's bound."""
    import torch

    from pyslam_tpu_torch.solver import bcsr, cuda_ops

    block = graph.blocks["poses"]
    dev, tname = block.values.device, str(block.values.dtype).split(".")[-1]
    dplan = bcsr.ell_device_plan(bcsr.build_ell_direct(graph), dev)
    batches = bcsr.ell_assemble_batches(graph)
    check(batches is not None, f"{label}: the graph is not one ell_assemble takes")
    args = (block.values, block.const_mask, batches, dplan.cols, dplan.a_idx, dplan.a_entries,
            dplan.h_offsets, dplan.a_first)
    out = cuda_ops.ell_assemble(*args)
    again = cuda_ops.ell_assemble(*args)
    ref = cuda_ops.ell_assemble_plain(*args)
    before = cuda_ops.LAUNCHES["ell_assemble"]
    routed = bcsr.assemble_ell(graph, dplan)
    torch.cuda.synchronize()
    check(cuda_ops.LAUNCHES["ell_assemble"] == before + 1, f"{label}: assemble_ell did not launch ell_assemble")
    worst = 0.0
    for name, a, b, c, r in zip(("He", "g", "chi2"), out, again, routed, ref):
        err, scale = (a - r).abs().max().item(), r.abs().max().item()
        log(f"ell_assemble {label} {tname} {name}{tuple(a.shape)}: max_abs_err {err!r} max|ref| {scale!r} "
            f"rel {err / scale!r}")
        check(a.shape == r.shape and torch.isfinite(a).all().item(), f"ell_assemble {label} {name}: shape or non-finite")
        check(torch.equal(a, b) and torch.equal(a, c), f"ell_assemble {label} {name}: two runs differ")
        check(err <= ASSEMBLE_TOL[tname] * scale, f"ell_assemble {label} {tname} {name}: error {err} > "
              f"{ASSEMBLE_TOL[tname]} * {scale}")
        worst = max(worst, err)
    if report is None:
        return
    report["ell_assemble"] = dict(max_abs_err=worst)
    times = dict(
        ms=median_ms(cuda_ops.ell_assemble, args, inner=BACK_TO_BACK),
        single_ms=median_ms(cuda_ops.ell_assemble, args),
        plain_ms=median_ms(cuda_ops.ell_assemble_plain, args, calls=10),
        # no one PyTorch call assembles: the general route that the kernel replaces
        library_ms=median_ms(bcsr.assemble_ell_general, (graph, dplan), calls=20),
    )
    measurements = [t for bt in batches for t in (bt.T_obs, bt.sqrt_info, bt.weight)]
    n_bytes = tensor_bytes(block.values, block.const_mask, *measurements, dplan.cols, dplan.a_idx, dplan.a_entries,
                           dplan.h_offsets, *out)
    n_rows = sum(bt.n_slots * bt.weight.shape[0] for bt in batches)
    flop = (ASSEMBLE_FLOP["factor"] * dplan.a_idx.shape[0] + ASSEMBLE_FLOP["contribution"] * dplan.a_entries.shape[0]
            + ASSEMBLE_FLOP["gradient_row"] * n_rows)
    add_times(report, "ell_assemble", "ms", times, n_bytes, flop)
    log(f"ell_assemble {label}: library_ms is the general route (ell_contributions + two slot_reduce + masks)")


def bsr_matrix(He, plan):
    """The ELL store as a ``torch.sparse_bsr_tensor`` (padding slots
    dropped, columns ascending within a row), for the library yardstick of
    ``ell_matvec``.  Built once, outside any timing."""
    import numpy as np
    import torch

    nb, K, d = plan.nb, plan.K, plan.d
    valid = plan.valid > 0
    order = np.argsort(np.where(valid, plan.cols, nb), axis=1, kind="stable")  # valid first, by column
    rows = np.repeat(np.arange(nb), K).reshape(nb, K)
    keep = np.take_along_axis(valid, order, axis=1)
    col = np.take_along_axis(plan.cols, order, axis=1)[keep]
    crow = np.concatenate([[0], np.cumsum(valid.sum(1))])
    flat = torch.from_numpy((rows * K + order)[keep]).to(He.device)
    values = He.reshape(nb * K, d, d)[flat].contiguous()
    return torch.sparse_bsr_tensor(
        torch.from_numpy(crow).to(He.device), torch.from_numpy(col.astype(np.int64)).to(He.device), values,
        size=(nb * d, nb * d),
    )


def index_add_library(contrib, perm, offsets, n_slots):
    """``out.index_add_(0, dest, contrib)`` as the library yardstick of
    ``slot_reduce``; ``dest`` (each contribution's slot) is built once on
    the device, outside the timing."""
    import torch

    counts = (offsets[1:] - offsets[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(n_slots, device=contrib.device), counts)
    dest = torch.empty_like(seg)
    dest[perm.long()] = seg

    def call():
        out = torch.zeros((n_slots, contrib.shape[1]), dtype=contrib.dtype, device=contrib.device)
        return out.index_add_(0, dest, contrib)

    return call


def main() -> int:
    import tempfile

    import numpy as np
    import torch

    # ---- phase 1: device -------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no GPU to run on")
    import pyslam_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from pyslam_tpu_torch import _ext
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import g2o, synth
    from pyslam_tpu_torch.losses import CauchyLoss
    from pyslam_tpu_torch.solver import assemble, cuda_ops, linear
    from pyslam_tpu_torch.solver.bcsr import (
        assemble_ell,
        build_ell_direct,
        ell_contributions,
        ell_device_plan,
        solve_ell,
    )
    from pyslam_tpu_torch.solver.lm import STATUS_NAMES, Options, _dense_solve, solve
    from pyslam_tpu_torch.testing import se3_stress_graph

    with open(os.path.join(ROOT, "bench", "baseline_cache.json")) as f:
        chi2_ref = float(json.load(f)["chi2"])
    with open(os.path.join(ROOT, "bench", "standin_cache.json")) as f:
        standin = json.load(f)

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

    # ---- phase 3: kernels vs plain versions at sphere2500 shapes -----------
    data = synth.se3_sphere(n_poses=N_POSES, seed=SEED)
    graph = build.pose_graph(data, dtype=torch.float32)
    check(graph.blocks["poses"].values.device.type == "cuda", "pose_graph did not build on the card by default")
    dev = graph.blocks["poses"].values.device
    plan = build_ell_direct(graph)
    dplan = ell_device_plan(plan, dev)
    nb, d, K = plan.nb, plan.d, plan.K
    h_contrib, g_contrib, _ = ell_contributions(graph, plan)
    He, g_vec, _ = assemble_ell(graph, dplan)
    x = torch.from_numpy(np.random.default_rng(SEED).normal(size=nb * d)).to(dev, torch.float32)
    torch.cuda.synchronize()
    log(
        f"shapes: nb={nb} K={K} d={d} edges={graph.batches[0].n} He={tuple(He.shape)} "
        f"h_contrib={tuple(h_contrib.shape)} g_contrib={tuple(g_contrib.shape)}"
    )
    report = {}
    # library yardstick of ell_matvec: one BSR product (6x6 blocks), the
    # matrix built once outside the timing
    bsr = bsr_matrix(He, plan)
    check_kernel("ell_matvec", cuda_ops.ell_matvec, cuda_ops.ell_matvec_plain, [He, dplan.cols, x], report, "ms",
                 flop=2 * nb * K * d * d, library=lambda: (bsr @ x[:, None])[:, 0])
    for contrib, perm, offsets, n_slots in ((h_contrib, dplan.h_perm, dplan.h_offsets, nb * K),
                                            (g_contrib, dplan.g_perm, dplan.g_offsets, nb)):
        check_kernel("slot_reduce", cuda_ops.slot_reduce, cuda_ops.slot_reduce_plain,
                     [contrib, perm, offsets, n_slots], report, "ms", flop=contrib.numel(),
                     library=index_add_library(contrib, perm, offsets, n_slots))
    # ell_pcg on the first linear system of the solve: He damped as solve_ell
    # damps it at lambda_init, its block-Jacobi inverse, the gradient
    He_d = He.clone()
    diag = torch.clamp(torch.diagonal(He[:, 0], dim1=-2, dim2=-1), min=1e-12)
    He_d[:, 0] += Options().lambda_init * torch.diag_embed(diag)
    check_pcg(He_d, dplan.cols, g_vec, 3e-6, 120, report)

    # ---- phase 3a: ell_assemble vs its plain version -----------------------
    # sphere2500 (timed), then the stress graph (special angles, priors,
    # padding, a frozen interior pose) under L2 and Cauchy, f32 and f64
    check_assemble("sphere2500", graph, report)
    check_assemble("sphere2500", build.pose_graph(data, dtype=torch.float64))
    for dtype in (torch.float32, torch.float64):
        check_assemble("stress graph L2", se3_stress_graph(dtype=dtype))
        check_assemble("stress graph Cauchy", se3_stress_graph(loss=CauchyLoss(2.0), dtype=dtype))
        check_assemble("sphere2500 Cauchy", build.pose_graph(data, loss=CauchyLoss(2.0), dtype=dtype))

    # ---- phase 3b: slot_reduce at the dense-assembly shapes of configs 1, 2, 7
    # The graphs that phases 6-8 solve.  Config 2's goes through the g2o
    # writer and reader, as in bench/run.py.
    loop = synth.se2_loop(n_poses=100, n_loops=12, seed=0)
    g_1 = build.pose_graph(loop, loss=CauchyLoss(2.0))
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m3500.g2o")
        g2o.write_g2o(path, synth.se2_manhattan(n_poses=3500, seed=1))
        m3500 = g2o.read_g2o(path)
    g_m = build.pose_graph(m3500, dtype=torch.float32)
    m_plan = assemble.dense_plan(g_m)
    loop7 = synth.sim3_loop(n_poses=400, n_loops=10, scale_drift=0.005, odo_scale_std=0.005, seed=0)
    g_7 = build.sim3_pose_graph(loop7)
    for cfg, g_d in (("config1", g_1), ("config2", g_m), ("config7", g_7)):
        d_plan = m_plan if g_d is g_m else assemble.dense_plan(g_d)
        h_parts, g_parts, _ = assemble.dense_contributions(g_d, hessian=True)
        groups = [(grp, h_parts) for grp in d_plan.h_groups] + [(grp, g_parts) for grp in d_plan.g_groups]
        for grp, parts in groups:
            contrib = torch.cat(parts[grp.shape]).contiguous()
            log(f"{cfg} dense group {grp.shape}: contributions {tuple(contrib.shape)} into {grp.n_slots} destinations")
            check_kernel("slot_reduce", cuda_ops.slot_reduce, cuda_ops.slot_reduce_plain,
                         [contrib, grp.perm, grp.offsets, grp.n_slots], report, f"{cfg}_ms", flop=contrib.numel(),
                         library=index_add_library(contrib, grp.perm, grp.offsets, grp.n_slots))
    torch.cuda.synchronize()

    launches_by_path = {}

    def drive(path, run, kernels):
        """Counts to 0, the path, counts read: each kernel of ``kernels``
        was launched and no plain version ran."""
        torch.cuda.synchronize()
        cuda_ops.reset_launches()
        linear.reset_host_reads()
        out = run()
        torch.cuda.synchronize()
        launches, reads = dict(cuda_ops.LAUNCHES), dict(linear.HOST_READS)
        for k in KERNELS:
            if k in kernels:
                check(launches[k] > 0, f"{path}: kernel {k} was not launched")
            check(launches[f"{k}_plain"] == 0, f"{path}: plain {k} ran")
        launches_by_path[path] = {k: launches[k] for k in kernels}
        return out, launches, reads

    def gate(name, chi2, factor, ref):
        log(f"{name}: chi2 {chi2!r} gate {factor * ref!r} ({factor} x {ref!r})")
        check(np.isfinite(chi2) and chi2 <= factor * ref, f"{name}: chi2 {chi2} above {factor} x {ref}")

    def check_poses(name, solved, shape):
        poses = solved.blocks["poses"].values
        check(tuple(poses.shape) == shape, f"{name}: poses shape {tuple(poses.shape)}")
        check(torch.isfinite(poses).all().item(), f"{name}: non-finite poses")

    # ---- phase 4: sphere2500 through solve_ell -----------------------------
    opts = Options(method="lm", max_iters=30, min_cost_decrease=0.999)

    def run_sphere():
        return solve_ell(graph, opts, plan=plan, pcg_rtol=3e-6, pcg_max_iters=120)

    t0 = time.perf_counter()
    run_sphere()  # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (solved, info), launches, reads = drive("sphere2500", run_sphere, ("ell_pcg", "ell_assemble"))
    chi2 = info.chi2.item()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cg_iters = cuda_ops.pcg_iterations()  # summed on the device by the launches, read once here
    log(
        f"solve sphere2500 f32: wall {wall!r} s (warm-up {warm!r} s), LM iterations {info.iterations}, "
        f"status {STATUS_NAMES[info.status]!r}, linear solves {launches['ell_pcg']}, CG iterations {cg_iters} "
        f"(cap 120 each), host reads {reads}, launches {launches}, peak memory {peak} B"
    )
    check(launches["ell_pcg"] == info.iterations, f"sphere2500: {launches['ell_pcg']} ell_pcg launches for "
          f"{info.iterations} linear solves")
    # speculative LM assembles once before the loop and once per trial point
    check(launches["ell_assemble"] == info.iterations + 1 and launches["slot_reduce"] == 0,
          f"sphere2500: {launches['ell_assemble']} ell_assemble and {launches['slot_reduce']} slot_reduce launches "
          f"for {info.iterations + 1} assemblies")
    check(reads == {"pcg": 0, "lm": info.iterations}, f"sphere2500: host reads {reads}, expected none by PCG "
          f"and one per LM iteration")
    check(0 < cg_iters <= 120 * info.iterations, f"sphere2500: {cg_iters} CG iterations on the device counter")
    gate("sphere2500", chi2, 1.001, chi2_ref)
    check_poses("sphere2500", solved, (N_POSES, 4, 4))

    # ---- phase 4b: sphere2500 by dogleg: the stand-alone ell_matvec --------
    # Not a cell of the reference's harness, so it has no gate of its own:
    # the trust region must bring the cost below a tenth of the start's.
    opts_dl = Options(method="dogleg", max_iters=30, min_cost_decrease=0.999)

    def run_sphere_dogleg():
        return solve_ell(graph, opts_dl, plan=plan, pcg_rtol=3e-6, pcg_max_iters=120)

    run_sphere_dogleg()
    t0 = time.perf_counter()
    (solved_dl, info_dl), launches, reads = drive("sphere2500_dogleg", run_sphere_dogleg,
                                                  ("ell_matvec", "ell_pcg", "ell_assemble"))
    chi2_dl, chi2_0 = info_dl.chi2.item(), info_dl.cost_history[0].item()
    wall = time.perf_counter() - t0
    log(
        f"solve sphere2500 dogleg f32: wall {wall!r} s, iterations {info_dl.iterations}, "
        f"status {STATUS_NAMES[info_dl.status]!r}, chi2 {chi2_0!r} -> {chi2_dl!r}, CG iterations "
        f"{cuda_ops.pcg_iterations()}, host reads {reads}, launches {launches}"
    )
    check(launches["ell_matvec"] == 2 * info_dl.iterations, "dogleg: two model products per iteration expected")
    check(launches["ell_pcg"] == info_dl.iterations and reads == {"pcg": 0, "lm": info_dl.iterations},
          f"dogleg: launches {launches}, host reads {reads}")
    check(launches["ell_assemble"] == info_dl.iterations + 1 and launches["slot_reduce"] == 0,
          f"dogleg: launches {launches} for {info_dl.iterations + 1} assemblies")
    check(np.isfinite(chi2_dl) and chi2_dl < 0.1 * chi2_0, f"dogleg: chi2 {chi2_0} -> {chi2_dl}")
    check_poses("sphere2500_dogleg", solved_dl, (N_POSES, 4, 4))

    # ---- phase 5: the kernels' path agrees with the CPU path ---------------
    small = synth.se3_sphere(n_poses=60, seed=11)
    res = {}
    for where in ("cpu", "cuda"):
        g_small = build.pose_graph(small, dtype=torch.float64, device=where)  # "cpu" must be asked for
        s_small, i_small = solve_ell(g_small, Options(method="lm", max_iters=20))
        res[where] = (i_small, s_small)
    cross_check("se3_sphere(60) solve_ell lm", res)

    # ---- phases 6-8: bench configs 1, 2 and 7 on the dense path ------------
    def run_dense(path, g, options, n_poses, shape):
        """Warm-up, then one timed solve; the path's checks and counts."""
        solve(g, options)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (solved, info), launches, reads = drive(path, lambda: solve(g, options), ("slot_reduce",))
        chi2 = info.chi2.item()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(reads == {"pcg": 0, "lm": info.iterations},
              f"{path}: host reads {reads}, expected one per LM iteration ({info.iterations})")
        failed = torch.nonzero(torch.isnan(info.update_norms[: info.iterations])).flatten().tolist()
        log(
            f"solve {path} f32: wall {wall!r} s, LM iterations {info.iterations}, "
            f"status {STATUS_NAMES[info.status]!r}, chi2 {chi2!r}, host reads {reads}, launches {launches}, "
            f"iterations with a failed Cholesky (NaN step) {failed}, peak memory {peak} B"
        )
        check_poses(path, solved, (n_poses, *shape))
        return solved, info, chi2

    # config 1: se2_loop(100) + Cauchy, timed; the gate is on the L2 graph
    opts1 = Options(method="lm", max_iters=50)
    run_dense("config1_se2_loop_cauchy", g_1, opts1, 100, (3, 3))
    _, _, chi2_l2 = run_dense("config1_se2_loop_l2", build.pose_graph(loop), opts1, 100, (3, 3))
    gate("config1 se2_loop_100 (L2 graph)", chi2_l2, STANDIN_GATE, standin["se2_loop_100"]["chi2"])

    # config 2: M3500-class, GN with exact solves, D = 10,500
    opts2 = Options(method="gn", max_iters=30, min_cost_decrease=0.999)
    D = g_m.total_dof
    _, _, chi2_m = run_dense("config2_m3500_g2o", g_m, opts2, 3500, (3, 3))
    gate("config2 se2_manhattan_3500", chi2_m, STANDIN_GATE, standin["se2_manhattan_3500"]["chi2"])
    H, gvec, _ = assemble.assemble_dense(g_m, m_plan)
    lam = torch.tensor(opts2.lambda_init, dtype=torch.float32, device=dev)
    dx = _dense_solve(H, gvec, lam, opts2)
    split = {
        "assemble_dense": host_ms(lambda: assemble.assemble_dense(g_m, m_plan)),
        "cholesky_ex": host_ms(lambda: torch.linalg.cholesky_ex(H)),
        "dense_solve (copy of H, Cholesky, 2 triangular solves)": host_ms(lambda: _dense_solve(H, gvec, lam, opts2)),
        "retract_all": host_ms(lambda: g_m.retract_all(dx)),
    }
    info_start = torch.linalg.cholesky_ex(assemble.unit_diag_where_dead(H))[1].item()
    log(f"config2 phase split, host ms per call (median of 5, synchronised): {split}; D = {D}, "
        f"H {D * D * 4} B; Cholesky info at the start point {info_start}")
    del H, gvec, dx

    # config 7: Sim(3) scale drift, 400 poses
    _, _, chi2_7 = run_dense("config7_sim3_400", g_7, Options(method="lm", max_iters=50), 400, (4, 4))
    gate("config7 sim3_loop_400", chi2_7, STANDIN_GATE, standin["sim3_loop_400"]["chi2"])

    # ---- phase 9: small f64 cross-checks, CPU path vs card path ------------
    loop_s = synth.sim3_loop(n_poses=40, n_loops=3, scale_drift=0.005, odo_scale_std=0.005, seed=0)
    for label, make, method in [("se2_loop(100) dense lm", lambda w: build.pose_graph(loop, dtype=torch.float64, device=w), "lm"),
                                ("se2_loop(100) dense dogleg", lambda w: build.pose_graph(loop, dtype=torch.float64, device=w), "dogleg"),
                                ("sim3_loop(40) dense lm", lambda w: build.sim3_pose_graph(loop_s, dtype=torch.float64, device=w), "lm")]:
        res = {where: solve(make(where), Options(method=method, max_iters=50))[::-1] for where in ("cpu", "cuda")}
        cross_check(label, res)
    opts_dl = Options(method="dogleg", max_iters=20)
    s_c, i_c = solve_ell(build.pose_graph(small, dtype=torch.float64, device="cpu"), opts_dl)
    g_small = build.pose_graph(small, dtype=torch.float64)
    (s_g, i_g), launches, reads = drive("solve_ell_dogleg_f64", lambda: solve_ell(g_small, opts_dl),
                                        ("ell_matvec", "ell_pcg", "ell_assemble"))
    res = {"cpu": (i_c, s_c), "cuda": (i_g, s_g)}
    cross_check("se3_sphere(60) solve_ell dogleg", res)
    log(f"solve_ell dogleg on the card: launches {launches}, CG iterations {cuda_ops.pcg_iterations()}, "
        f"host reads {reads}, LM iterations {i_g.iterations}")
    check(launches["ell_matvec"] == 2 * i_g.iterations and launches["ell_pcg"] == i_g.iterations
          and launches["ell_assemble"] == i_g.iterations + 1 and reads["pcg"] == 0,
          "solve_ell dogleg: model products, linear solves or assemblies left the kernels")

    sources = {"ell_matvec": "pyslam_tpu_torch/csrc/ell_matvec.cu",
               "ell_pcg": "pyslam_tpu_torch/csrc/ell_pcg.cu",
               "slot_reduce": "pyslam_tpu_torch/csrc/slot_reduce.cu",
               "ell_assemble": "pyslam_tpu_torch/csrc/ell_assemble.cu"}
    # ell_pcg is ell_matvec_lane_major at the grain of its caller, the
    # while_loop of pyslam_tpu/solver/linear.py:38-61; ell_assemble is
    # scatter_matmul at the grain of its caller, assemble_ell of
    # pyslam_tpu/solver/bcsr.py:410-439
    replaces = {"ell_matvec": "pyslam_tpu/solver/pallas_ops.py:60",
                "ell_pcg": "pyslam_tpu/solver/pallas_ops.py:60",
                "slot_reduce": "pyslam_tpu/solver/pallas_ops.py:143",
                "ell_assemble": "pyslam_tpu/solver/pallas_ops.py:143"}
    main_paths = ("sphere2500", "sphere2500_dogleg", "config1_se2_loop_cauchy", "config1_se2_loop_l2",
                  "config2_m3500_g2o", "config7_sim3_400")
    kernels = [
        dict(name=k, route="cuda", source=sources[k], replaces=replaces[k],
             launches=sum(launches_by_path[p].get(k, 0) for p in main_paths),
             launches_by_path={p: launches_by_path[p][k] for p in main_paths if k in launches_by_path[p]},
             **report[k])
        for k in KERNELS
    ]
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} was launched on no main path")
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
            check(key in k, f"kernel {k['name']}: no {key}")
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


def cross_check(label, res):
    """The CPU and card runs of one f64 solve: ``res[where] = (info,
    solved)``; the same iterations and stop code, chi2 within 1e-8
    relative, poses within 1e-6."""
    (i_c, s_c), (i_g, s_g) = res["cpu"], res["cuda"]
    c_c, c_g = i_c.chi2.item(), i_g.chi2.item()
    pose_err = (s_c.blocks["poses"].values - s_g.blocks["poses"].values.cpu()).abs().max().item()
    log(f"f64 {label}: cpu {i_c.iterations} it status {i_c.status} chi2 {c_c!r}; "
        f"cuda {i_g.iterations} it status {i_g.status} chi2 {c_g!r}; pose diff {pose_err!r}")
    check((i_c.iterations, i_c.status) == (i_g.iterations, i_g.status),
          f"{label}: CPU and CUDA paths took different iterations or stop codes")
    check(abs(c_c - c_g) <= 1e-8 * abs(c_c), f"{label}: CPU and CUDA chi2 differ by more than 1e-8 rel")
    check(pose_err <= 1e-6, f"{label}: CPU and CUDA poses differ by more than 1e-6")


if __name__ == "__main__":
    sys.exit(main())
