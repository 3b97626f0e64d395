#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``pyslam_tpu_torch``) on one
NVIDIA GPU: builds its CUDA kernels, checks each against its plain PyTorch
version at the shapes its paths give it, and drives each ported path
through the entry points a user calls, checking that it reaches its
converged cost and went through the kernels:

  * sphere2500 (SE(3), ``build.pose_graph`` + ``bcsr.solve_ell``), gate
    chi2 <= 1.001 x ``bench/baseline_cache.json``;
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
# The 1% gates of bench/run.py on the converged costs of the stand-in
# solvers, by the keys of bench/standin_cache.json.
STANDIN_GATE = 1.01
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


def check_kernel(name, fn, plain, args, report, key):
    """``fn`` against ``plain`` on the same inputs in f32 and f64, then the
    device time of each in f32, accumulated into ``report[name]`` under
    ``key`` / ``"plain_" + key``."""
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
        r = report.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0))
        if dtype is torch.float32:
            r["max_abs_err"] = max(r["max_abs_err"], err)
    ms = median_ms(fn, args)
    plain_ms = median_ms(plain, args)
    log(f"{name} f32 out{tuple(fn(*args).shape)}: device time per call: kernel {ms!r} ms, "
        f"plain {plain_ms!r} ms (median of {TIMING_CALLS})")
    r[key] = r.get(key, 0.0) + ms
    r["plain_" + key] = r.get("plain_" + key, 0.0) + plain_ms


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

    with open(os.path.join(ROOT, "bench", "baseline_cache.json")) as f:
        chi2_ref = float(json.load(f)["chi2"])
    with open(os.path.join(ROOT, "bench", "standin_cache.json")) as f:
        standin = json.load(f)

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

    # ---- phase 3: kernels vs plain versions at sphere2500 shapes -----------
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
    report = {}
    check_kernel("ell_matvec", cuda_ops.ell_matvec, cuda_ops.ell_matvec_plain, [He, dplan.cols, x], report, "ms")
    check_kernel("slot_reduce", cuda_ops.slot_reduce, cuda_ops.slot_reduce_plain,
                 [h_contrib, dplan.h_perm, dplan.h_offsets, nb * K], report, "ms")
    check_kernel("slot_reduce", cuda_ops.slot_reduce, cuda_ops.slot_reduce_plain,
                 [g_contrib, dplan.g_perm, dplan.g_offsets, nb], report, "ms")

    # ---- phase 3b: slot_reduce at the dense-assembly shapes of configs 1, 2, 7
    # The graphs that phases 6-8 solve.  Config 2's goes through the g2o
    # writer and reader, as in bench/run.py.
    loop = synth.se2_loop(n_poses=100, n_loops=12, seed=0)
    g_1 = build.pose_graph(loop, loss=CauchyLoss(2.0), device=dev)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m3500.g2o")
        g2o.write_g2o(path, synth.se2_manhattan(n_poses=3500, seed=1))
        m3500 = g2o.read_g2o(path)
    g_m = build.pose_graph(m3500, dtype=torch.float32, device=dev)
    m_plan = assemble.dense_plan(g_m)
    loop7 = synth.sim3_loop(n_poses=400, n_loops=10, scale_drift=0.005, odo_scale_std=0.005, seed=0)
    g_7 = build.sim3_pose_graph(loop7, device=dev)
    for cfg, g_d in (("config1", g_1), ("config2", g_m), ("config7", g_7)):
        d_plan = m_plan if g_d is g_m else assemble.dense_plan(g_d)
        h_parts, g_parts, _ = assemble.dense_contributions(g_d, hessian=True)
        groups = [(grp, h_parts) for grp in d_plan.h_groups] + [(grp, g_parts) for grp in d_plan.g_groups]
        for grp, parts in groups:
            contrib = torch.cat(parts[grp.shape]).contiguous()
            log(f"{cfg} dense group {grp.shape}: contributions {tuple(contrib.shape)} into {grp.n_slots} destinations")
            check_kernel("slot_reduce", cuda_ops.slot_reduce, cuda_ops.slot_reduce_plain,
                         [contrib, grp.perm, grp.offsets, grp.n_slots], report, f"{cfg}_ms")
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
        for k in ("ell_matvec", "slot_reduce"):
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
    (solved, info), launches, reads = drive("sphere2500", run_sphere, ("ell_matvec", "slot_reduce"))
    chi2 = info.chi2.item()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cg_iters = launches["ell_matvec"] - info.iterations  # one r0 matvec per linear solve
    log(
        f"solve sphere2500 f32: wall {wall!r} s (warm-up {warm!r} s), LM iterations {info.iterations}, "
        f"status {STATUS_NAMES[info.status]!r}, CG iterations {cg_iters}, host reads {reads}, "
        f"launches {launches}, peak memory {peak} B"
    )
    gate("sphere2500", chi2, 1.001, chi2_ref)
    check_poses("sphere2500", solved, (N_POSES, 4, 4))

    # ---- phase 5: the kernels' path agrees with the CPU path ---------------
    small = synth.se3_sphere(n_poses=60, seed=11)
    res = {}
    for where in ("cpu", "cuda"):
        g_small = build.pose_graph(small, dtype=torch.float64, device=where)
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
    _, _, chi2_l2 = run_dense("config1_se2_loop_l2", build.pose_graph(loop, device=dev), opts1, 100, (3, 3))
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
    g_small = build.pose_graph(small, dtype=torch.float64, device=dev)
    (s_g, i_g), launches, reads = drive("solve_ell_dogleg_f64", lambda: solve_ell(g_small, opts_dl),
                                        ("ell_matvec", "slot_reduce"))
    res = {"cpu": (i_c, s_c), "cuda": (i_g, s_g)}
    cross_check("se3_sphere(60) solve_ell dogleg", res)
    # per LM iteration: one r0 matvec, the CG matvecs, and dogleg's two
    # model matvecs; the CG stop tests bound the CG iterations from above
    log(f"solve_ell dogleg on the card: ell_matvec launches {launches['ell_matvec']}, "
        f"CG stop tests {reads['pcg']}, LM iterations {i_g.iterations}")
    check(launches["ell_matvec"] >= reads["pcg"] + 2 * i_g.iterations,
          "solve_ell dogleg did not run its model matvecs through ell_matvec")

    sources = {"ell_matvec": "pyslam_tpu_torch/csrc/ell_matvec.cu",
               "slot_reduce": "pyslam_tpu_torch/csrc/slot_reduce.cu"}
    replaces = {"ell_matvec": "pyslam_tpu/solver/pallas_ops.py:60",
                "slot_reduce": "pyslam_tpu/solver/pallas_ops.py:143"}
    main_paths = ("sphere2500", "config1_se2_loop_cauchy", "config1_se2_loop_l2", "config2_m3500_g2o",
                  "config7_sim3_400")
    kernels = [
        dict(name=k, route="cuda", source=sources[k], replaces=replaces[k],
             launches=sum(launches_by_path[p].get(k, 0) for p in main_paths),
             launches_by_path={p: launches_by_path[p][k] for p in main_paths if k in launches_by_path[p]},
             **v)
        for k, v in report.items()
    ]
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
