#!/usr/bin/env python3
"""Profile of the PyTorch + CUDA port's solves on one NVIDIA GPU: the wall
time, the device's busy share and, for the dense cells, the host time of
each phase of an iteration.

    python3 profile_port.py [--cells sphere2500,config1,...,venice_mini,config6]
                            [--reps 7] [--root DIR]

Each cell is the one ``chip_smoke.py`` drives (f32, the reference
harness's options).  Per cell:

  * wall: one warm-up solve, then the median of ``--reps`` solves, each
    timed on the host clock from the call to the converged chi2 read back
    with ``.item()``;
  * busy share: one more solve under ``torch.profiler``
    (CPU and CUDA activities); the summed self device time of its kernel
    events divided by the unprofiled median wall.  Also the kernels
    launched per solve and the ten longest kernels;
  * host ms per call (dense cells): ``dense_plan``, the linearization
    (``dense_contributions``), ``assemble_dense``, ``cholesky_ex``,
    ``_dense_solve`` and ``retract_all`` at the start point, each the
    median of ``--reps`` calls after one warm-up, every call closed by
    ``torch.cuda.synchronize()``;
  * host ms per call (sphere2500), measured the same way:
    ``ell_device_plan``, ``assemble_ell``, inside it the ``ell_assemble``
    kernel alone (linearization, reduction and masks in two launches) and
    beside it the general route it replaced (``assemble_ell_general``); on a
    checkout from before that kernel, ``assemble_ell`` and the linearization
    alone (``ell_contributions``, which two ``slot_reduce`` followed); the
    damping with ``sym_block_inv``, one PCG linear solve at the start point
    (the ``ell_pcg`` kernel; on a checkout from before that kernel, the host
    loop over ``ell_matvec`` that ``solve_ell`` ran then) and
    ``retract_all``;
  * host ms per call (``config4``, ``config4_dense``: bundle adjustment of
    49 cameras and 7,000 points through ``solve_schur`` in its 'pcg' and
    'dense' modes), measured the same way: ``schur_plan``, the
    linearization, ``ba_assemble``, ``_schur_reduce``, the whole linear
    solve of either mode, inside the 'pcg' one the CG loop alone
    (``linear.pcg_solve``, timed from within the call between two
    synchronisations, with its iteration count), ``_back_substitute`` and
    ``retract_all``, and the ``slot_reduce`` launches and host reads of one
    solve;
  * the runtime's stream and device synchronisations and memory copies
    counted in the profiled solve.

Cells of the sparse direct paths and the dispatch (f32, as
``chip_smoke.py`` drives them): ``config8`` (``solve_auto`` on bench config
8's landmark graph, route ``schur_dense``; split as ``config4_dense``),
``config2_sparse_chol`` (``solve_sparse_chol`` on config 2's graph, the plan
built once), ``sparse_chol_5000`` (``solve_auto`` on
``se2_manhattan(5000)``, route ``sparse_chol``, the nested dissection in
every solve), ``schur_sparse_2000`` (``solve_auto`` on
``landmark_slam_2d(2000, 300)``, route ``schur_sparse``) and ``fleet16``
(``solve_batched`` on 16 ``se2_loop(100)``; its LM iterations are the
fleet's, its chi2 the sum).  Host ms per call of the sparse cells: the
plans (``build_chol_plan`` / ``build_schur_sparse_plan``), the assembly,
``_factorize`` (with ``assemble_S_ell`` for the Schur cell) and
``_solve_factored`` at the start point, and ``retract_all``; and the
``slot_reduce`` launches and host reads of one solve.

The cell ``config5`` is bench config 5 on its own path: Venice-mini through
``dist.solve_schur_sharded`` on a 1-rank NCCL mesh (f32, PCG 1e-4 / 30, LM
15; at least 9 repetitions), with the host ms of ``shard_ba``, of one LM
step with and without its CG loop and of one ``psum``, and one solve's
collectives, ``slot_reduce`` launches, host reads, CG iterations and peak
memory.  Every cell prints its median wall with the quartiles.

Cells of ``solve_schur_large`` (f32, the plan built once, outside the
timing): ``venice_mini`` (bench config 5's problem, 300 cameras / 60,000
points, PCG 1e-4 / 30, LM 15) and ``config6`` (1,700 cameras / 1,000,000
points / 4,650,850 observations, n_chunks 128, PCG 1e-4 / 12, LM 10; at
most 3 repetitions).  Their iterations are the accepted LM steps.  Host ms
per call: the plan's parts (the indices to the host, the stable argsort by
camera, the landmark plan, the whole ``prepare_large_ba``) and
``build_dense_pairs``; ``_linearize``, the cost-only pass, ``_reduce``
(damping, Hll⁻¹, g_red, D), the block inverse of D, one Schur product, one
CG loop (with its iterations) and the back-substitution at the start
point; the CG loop alone on those inputs, ``pcg_guarded_plain`` below (a
read an iteration, no masks) against ``schur_large._pcg`` read every
fourth iteration and never, 30 turns each in alternation; then one solve's
``slot_reduce`` launches, host reads, CG iterations and peak memory.

The extra cell ``config4_pcg_loops`` (not in the default list) times
config 4 in 'pcg' mode under each way of running the CG loop: the plain
host loop of ``linear.pcg_solve`` (the stop test read every iteration,
what ``schur_solve_pcg`` runs) and ``pcg_solve_masked`` below (the stop
test applied on the device) reading it every 1, 2, 5 or 10 iterations or
never (every solve then runs to its cap).  The variants are set from
outside (``schur.pcg_solve``); each must give the same LM iterations and
chi2.  They take turns solve by solve
(``--reps`` rounds of one solve each after a warm-up round), so that a
drift of the host's speed falls on all alike.

The extra cell ``sharded_cg_reads`` (not in the default list) runs
``solve_pose_sharded`` and ``solve_schur_sharded`` on graphs whose CG
stops well inside its default budget, with the stop test read never (what
the solvers run), every iteration and every 8th, in turns (at least 9
rounds), on a 1-rank NCCL mesh: the median wall with quartiles, the CG
iterations and the collectives of a solve under each.

The extra cells of ``slot_reduce`` (not in the default list), each with
the parent checkout's ``slot_reduce`` beside when ``--parent DIR`` names
one (its package loaded under a name of its own: its wrapper, its body
rule and its kernels, its library built from its sources):
``slot_sweep`` times the kernel on random plans of 1,024 to 131,072
destinations, uniform and Zipf-distributed rows a destination;
``slot_pairs`` prints the rows a destination of bench config 6's two pair
plans (``cluster`` 64 and ``stale``) and times the kernel, ``index_add_``
and the plain version there beside the bound; ``slot_shapes`` times the
kernel and the parent's in turns at every shape of PERF.md's kernel table,
recorded from one solve of each cell, and at the benchmark's BAL sums by
landmark (Venice's and BAL Final's, drawn by their generators).  Each
names the body each side's rule gives the plan
(``cuda_ops.slot_reduce_body``).

The extra cell ``block_idioms`` (not in the default list) times the Schur
path's small block products at config 6's shapes in two forms, batched
``@`` and broadcast products, and Hll's inverse by Cholesky and by the
adjugate.

The extra cell ``pcg_columns`` (not in the default list) times the
``ell_pcg`` kernel alone, with the kernel of another checkout beside when
``--parent DIR`` names one (its library built from its sources, as the
slot cells build theirs), in turns, at least 9 rounds, one launch between
CUDA events each: sphere2500's main-path solve (damped, m = 1, f32 and
f64), both chordal rotation stages (d = 9 and 4), the covariance system
with 36 columns and with one (f64), and the non-resident plan (30,000
rows); the median, spread and µs an iteration of each, and whether x and
the counts equal the parent's bit for bit.  Then the split of a launch
into its phases (a copy of the kernel with clock marks at its block
barriers), one barrier of each kind alone at the kernel's grid
(``grid.sync()`` with a read of the G partial sums, against the carrying
barrier with and without its fences), and ``torch.cholesky_solve`` of the
36 columns on the dense factor.

The extra cell ``assemble`` (not in the default list) times the
``ell_assemble`` kernel alone, with the kernel of another checkout beside
when ``--parent DIR`` names one (its library built from its sources; it
is called through the C entry of the slot-grained kernel, with the tables
it read, the Hessian slot plan's entries), in turns (parent, this, this, parent, ...), at least
9 rounds: sphere2500 and the 30,000-pose sphere in f32 and f64, the stress
graph under a Cauchy loss in f32 and f64, and the graph whose factors share
pose pairs in f64.  Each round times one call between CUDA events and 20
back to back; then each side's kernels under ``torch.profiler`` by name,
the wrapper's host µs a call, whether He, g and chi2 equal the parent's bit
for bit, and each side's registers and stack from the compiler's report.

The extra cell ``bal_rows`` (not in the default list) times the
``bal_rows`` kernel alone at Venice's size: the ``venice_ba`` problem of
``portbench`` (1,778 cameras, 993,923 points, 5,001,946 observations, seed
1) through its plan, in f32 (the benchmark's) and f64; and its 9-dof
instantiation at BAL Final's size, the ``bal_final13682`` problem (13,682
cameras of 9 parameters, 4,456,117 points, 28,987,644 observations, seed 1),
in f32.  In turns, at least 9 rounds: one call between CUDA events and 20
back to back, with rows and without (the cost-only pass), and with
``--parent DIR`` the parent checkout's 6-dof kernel beside (its library
built from its sources, called through its C entry on the same tensors;
whether its bits are this kernel's); then once the plain twin
(``bal_rows_plain`` over the plan's chunks) between events, and three times
in turns the chunked path it replaces (``_obs_rows`` with the plan's
``bal`` taken off, 128 chunks) and ``_obs_rows`` through the kernel, on the
host clock, synchronised; the bound by bytes; whether two launches give the
same bits and the largest difference from the twin relative to each
column's largest sum of the magnitudes of its terms
(``cuda_ops.bal_rows_scale``); the compiler's registers.

The extra cell ``kernels`` (not in the default list) is no solve: it runs
sphere2500's ``assemble_ell`` and its two ``slot_reduce`` calls 50 times
under ``torch.profiler``, in f32 and f64, and prints the mean device time
of every kernel by name (the two stages of ``ell_assemble`` apart).

The cells of phases 32 to 36 (f64 but ``sqrt_ladybug``): ``vio_window``,
``fixed_lag_sphere2500``, ``fixed_lag_lm_config8`` and
``incremental_m3500`` are streams, timed frame by frame (a keyframe, a
frame of the window, an update) on the host clock, each frame ending in its
read of the poses: the median and quartiles over the frames after the
first 30 (over the incremental cell's updates but its 14th, the largest,
which is profiled), and 30 frames under ``torch.profiler`` for the kernels
and device ms of a frame and the busy share (device ms a frame over the
unprofiled median; for the incremental cell over the profiled update's
own wall); ``sqrt_ladybug`` is one ``solve_auto`` through the
``schur_sqrt`` route (f32), timed and split as a solve (the plan, the
linearization into buckets, one elimination and reduced solve).

The VO cells of phase 46 (f32, ``bench/vo_overlap.py``'s VGA frames, 4
levels): ``vo_rgbd_vga`` tracks the 40 frames one by one, ``--reps`` runs
on fresh pipelines, each frame timed on the host clock up to its pose read
back (the keyframe and the first tracked frame of a run left out), then 10
frames under ``torch.profiler``; ``vo_batch16`` runs ``bench/vo_batch.py``'s
protocol (the keyframe, then two ``track_batch`` calls of 16 frames) on
``--reps`` fresh pipelines after a warm-up, each batch's wall over 16 a
frame, then one batch under ``torch.profiler``. Each prints the median and
quartiles of the ms a frame, the fps, the kernels and device ms a frame,
the busy share and the synchronizing runtime calls a frame; ``vo_rgbd_vga``
also the host ms of an LM iteration's parts at level 0 (the dense cells'
split, the photometric kernel with its Jacobian, the Student-t scale).

The cells of slice 14 (not in the default list): ``schur_cm_config5``,
bench config 5 through ``dist.solve_schur_cm`` on a 1-rank NCCL mesh
(split as ``config5``: the plan, a step with and without its CG loop);
``precond_config6``, bench config 6 through ``solve_schur_large`` with
``precond`` "jacobi", "cluster" (64 cameras) and "stale" (refresh 3) in
turns, the plan and pair tables built once, a median with quartiles of
each; ``bcsr_sphere2500`` and ``two_level_sphere2500``, sphere2500
through ``solve_bcsr`` (spmv "ell") and ``solve_ell(precond="two_level")``
at config 3's options.

``--root`` imports ``pyslam_tpu_torch`` from another checkout, such as a
parent commit unpacked beside this one (the sphere2500 cell runs on every
version of the port; the dense cells need the dense path).  The graphs
are built on the package's default device, the CUDA card; a checkout from
before ``default_device`` is given ``cuda:0`` by name.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

CELLS = ("sphere2500", "config1", "config2", "config7", "config4", "config4_dense", "config8", "config2_sparse_chol",
         "sparse_chol_5000", "schur_sparse_2000", "fleet16", "venice_mini", "config6", "config5", "init_sphere2500",
         "gnc_sphere2500", "switch_m3500", "vio400", "vio_window", "fixed_lag_sphere2500", "fixed_lag_lm_config8",
         "incremental_m3500", "sqrt_ladybug", "vo_rgbd_vga", "vo_batch16")
# cells timed over at least 9 solves
MIN_NINE = ("config5", "schur_cm_config5", "init_sphere2500", "gnc_sphere2500", "switch_m3500", "vio400", "sqrt_ladybug")
RUNTIME_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")


def host_ms(fn, reps):
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


def pcg_solve_masked(matvec, b, precond, rtol=1e-6, max_iters=500, read_every=0):
    """``linear.pcg_solve`` from x0 = 0 with the stop test applied on the
    device: every iteration is computed, and once ``norm(r) > rtol * norm(b)``
    fails (a NaN fails it) ``torch.where`` keeps x, r, p and rz as they are,
    so the result is the one ``pcg_solve`` returns after the same iterations.
    The host reads the stop test before iterations 0, ``read_every``, 2
    ``read_every``, ... and leaves the loop where it has failed;
    ``read_every=0`` never reads and runs ``max_iters`` iterations.
    Returns (x, iterations), the count a 0-dim int32 tensor on b's device.
    The variant that ``config4_pcg_loops`` times against the plain loop."""
    import torch

    from pyslam_tpu_torch.solver.linear import HOST_READS

    x = torch.zeros_like(b)
    tol = rtol * torch.linalg.norm(b)
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    for k in range(max_iters):
        go = torch.linalg.norm(r) > tol
        if read_every and k % read_every == 0:
            HOST_READS["pcg"] += 1
            if not bool(go):
                break
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = torch.where(go, x + alpha * p, x)
        r = torch.where(go, r - alpha * Ap, r)
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = torch.where(go, z + (rz_new / rz) * p, p)
        rz = torch.where(go, rz_new, rz)
        it = it + go
    return x, it


def pcg_guarded_plain(matvec, precond, b, rtol, max_iters):
    """``schur_large._pcg`` with its stop test read by the host before every
    iteration and no masks: the loop the ``venice_mini`` and ``config6``
    cells time it against.  Returns (x, iterations)."""
    import torch

    from pyslam_tpu_torch.solver.linear import HOST_READS

    x = torch.zeros_like(b)
    r, z = b, precond(b)
    p, rz, rn2 = z, torch.dot(b, z), torch.dot(b, b)
    tol2 = rtol**2 * rn2
    it = 0
    while it < max_iters:
        HOST_READS["pcg"] += 1
        if not bool(rn2 > tol2):
            break
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        ok = (rz > 0.0) & (pAp > 0.0)
        alpha = torch.where(ok, rz / torch.where(ok, pAp, 1.0), 0.0)
        x = x + alpha * p
        r = torch.where(ok, r - alpha * Ap, r)
        z = precond(r)
        rz_new = torch.where(ok, torch.dot(r, z), rz)
        beta = torch.where(ok, rz_new / torch.where(ok, rz, 1.0), 0.0)
        p = torch.where(ok, z + beta * p, p)
        rz, rn2 = rz_new, torch.dot(r, r)
        it += 1
    return x, it


class GncCellInfo(NamedTuple):
    """What the timing loop reads of a GNC solve."""

    chi2: object  # 0-dim tensor: the robustified chi2
    iterations: int  # outer iterations
    status: None


def slice9_cell(name, dev):
    """(graph, options, run) of the cells of chip_smoke's phases 28 to 31
    (f32 but vio400, f64)."""
    import numpy as np
    import torch

    from chip_smoke import euroc_round_trip, m3500_data, vio_inputs
    from pyslam_tpu_torch import imu
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import solve, solve_gnc
    from pyslam_tpu_torch.solver.bcsr import solve_ell
    from pyslam_tpu_torch.solver.lm import Options

    if name == "init_sphere2500":
        data = synth.se3_sphere(n_poses=2500, seed=0)
        o = Options(method="lm", max_iters=30, min_cost_decrease=0.999)

        def run():
            g = build.pose_graph(data, init="chordal", device=dev)
            return solve_ell(g, o, pcg_rtol=3e-6, pcg_max_iters=120)

        return build.pose_graph(data, device=dev), o, run
    if name == "gnc_sphere2500":
        data, _ = synth.with_outliers(synth.se3_sphere(n_poses=2500, seed=0), 100, magnitude=2.0, seed=1)
        g, o = build.pose_graph(data, device=dev), Options(method="lm")

        def run_gnc():
            solved, info = solve_gnc(g, o)
            return solved, GncCellInfo(torch.tensor(info.chi2), info.outer_iters, None)

        return g, o, run_gnc
    if name == "switch_m3500":
        poisoned, _ = synth.with_outliers(m3500_data(), 100, seed=2)
        g, o = build.switchable_pose_graph(poisoned, xi=5.0, device=dev), Options(method="lm", max_iters=60)
        return g, o, lambda: solve(g, o)
    d, T_prior = vio_inputs()
    with tempfile.TemporaryDirectory() as td:
        _, data = euroc_round_trip(d, td)
    n = d.T_gt.shape[0]
    g = imu.vio_graph(data, T_prior, np.diag([1 / 2e-3] * 6), T_init=T_prior, v_init=np.zeros((n, 3)),
                      b_init=np.zeros((n, 6)), device=dev)
    o = Options(method="lm", max_iters=60)
    return g, o, lambda: solve(g, o)


def slice9_split(name, g, o, dev, reps):
    """Host ms of the parts of the cells of phases 28 to 31."""
    import numpy as np
    import torch

    from chip_smoke import euroc_round_trip, vio_inputs
    from pyslam_tpu_torch import imu
    from pyslam_tpu_torch.graph import initialize
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import bcsr, cuda_ops, gnc, linear, solve_auto
    from pyslam_tpu_torch.solver.lm import Options

    if name == "init_sphere2500":
        data = synth.se3_sphere(n_poses=2500, seed=0)
        args = (data.edges_i, data.edges_j, data.T_meas, 2500)
        R = np.asarray(data.T_meas)[:, :3, :3]
        gn = Options(method="gn", max_iters=3, min_cost_decrease=0.999)
        g_rot = initialize._rotation_graph(data.edges_i, data.edges_j, R, 2500, 0, np.eye(3), torch.float32, dev)
        g_t = initialize._translation_graph(data.edges_i, data.edges_j, R, np.asarray(data.T_meas)[:, :3, 3], 2500,
                                            0, np.zeros(3), torch.float32, dev)
        return dict(
            spanning_tree_init=host_ms(lambda: initialize.spanning_tree_init(*args), reps),
            chordal_init=host_ms(lambda: initialize.chordal_init(*args, dtype=torch.float32, device=dev), reps),
            rotation_stage=host_ms(lambda: initialize._solve_stage(g_rot, gn, 1e-6, 250), reps),
            translation_stage=host_ms(lambda: initialize._solve_stage(g_t, gn, 1e-6, 250), reps),
            solve_ell_from_odometry=host_ms(lambda: bcsr.solve_ell(g, o, pcg_rtol=3e-6, pcg_max_iters=120), reps),
        )
    if name == "gnc_sphere2500":
        plan = bcsr.build_ell_direct(g)
        inner = gnc.dataclasses.replace(o, max_iters=10)
        r2 = gnc._r2_per_factor(g, [0])
        cuda_ops.reset_launches()
        linear.reset_host_reads()
        solve_auto(g, inner)
        torch.cuda.synchronize()
        counts = dict(cuda_ops.LAUNCHES, lm_reads=linear.HOST_READS["lm"])
        return dict(
            build_ell_direct=host_ms(lambda: bcsr.build_ell_direct(g), reps),
            ell_device_plan=host_ms(lambda: bcsr.ell_device_plan(plan, dev), reps),
            inner_solve_from_the_start=host_ms(lambda: solve_auto(g, inner), reps),
            weight_update_and_stop_read=host_ms(
                lambda: float(torch.abs(gnc._tls_weights(r2[0], 0.5, 12.59) - 0.5).sum()), reps),
            inner_solve_counts=counts,
        )
    split = dense_split(g, o, dev, reps)
    if name == "vio400":
        d, T_prior = vio_inputs()
        with tempfile.TemporaryDirectory() as td:
            split["euroc_round_trip"] = host_ms(lambda: euroc_round_trip(d, td), 1)
            _, data = euroc_round_trip(d, td)
        w, a, dts = (torch.from_numpy(x).to(dev) for x in imu._padded_intervals(data.omega, data.accel, data.dts))
        z = torch.zeros((w.shape[0], 3), dtype=torch.float64, device=dev)
        pim = imu._preintegrate_batched(w, a, dts, z, z, 1.7e-4, 2e-3)
        cov = pim.cov.cpu().numpy()
        n = d.T_gt.shape[0]
        split.update(
            preintegration=host_ms(lambda: imu._preintegrate_batched(w, a, dts, z, z, 1.7e-4, 2e-3), reps),
            covariances_to_host=host_ms(lambda: pim.cov.cpu(), reps),
            sqrt_info_host=host_ms(lambda: imu._sqrt_info_host(cov, 1e-12), reps),
            vio_graph=host_ms(lambda: imu.vio_graph(data, T_prior, np.diag([1 / 2e-3] * 6), T_init=T_prior,
                                                    v_init=np.zeros((n, 3)), b_init=np.zeros((n, 6)), device=dev),
                              reps),
        )
    return split


ONLINE_CELLS = ("vio_window", "fixed_lag_sphere2500", "fixed_lag_lm_config8", "incremental_m3500")
VO_CELLS = ("vo_rgbd_vga", "vo_batch16")


def vo_cell(name, dev, dev_us, reps):
    """The VO cells of phase 46 (see the module docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pyslam_tpu_torch.pipelines import DenseRGBDPipeline
    from pyslam_tpu_torch.sensors import RGBDCamera
    from pyslam_tpu_torch.testing import VO_CAM, vo_frames

    frames = vo_frames(40)
    ims = [im for im, _ in frames[1:]]

    def pipeline():
        pipe = DenseRGBDPipeline(RGBDCamera(**VO_CAM), pyrlevels=4, keyframe_trans_thresh=1e9, device=dev)
        pipe.track(*frames[0])
        return pipe

    walls = []  # ms a frame
    if name == "vo_rgbd_vga":
        for _ in range(reps):
            pipe = pipeline()
            pipe.track(*frames[1])
            for im, depth in frames[2:]:
                t0 = time.perf_counter()
                pipe.track(im, depth)
                walls.append(1e3 * (time.perf_counter() - t0))
        pipe, n_prof = pipeline(), 10
        pipe.track(*frames[1])

        def segment():
            for im, depth in frames[2: 2 + n_prof]:
                pipe.track(im, depth)
    else:
        pipeline().track_batch(ims[:16])  # warm-up
        for _ in range(reps):
            pipe = pipeline()
            for s in (0, 16):
                t0 = time.perf_counter()
                pipe.track_batch(ims[s: s + 16])
                walls.append(1e3 * (time.perf_counter() - t0) / 16)
        pipe, n_prof = pipeline(), 16

        def segment():
            pipe.track_batch(ims[:16])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        segment()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    kern = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kern) / 1e3 / n_prof
    q = statistics.quantiles(walls, n=4)
    med = statistics.median(walls)
    print(f"== {name}: ms a frame median of {len(walls)} {med!r}, quartiles {q[0]!r} to {q[2]!r}, p90 "
          f"{float(np.percentile(walls, 90))!r}; {1e3 / med!r} fps", flush=True)
    print(f"   profiled {n_prof} frames: {sum(e.count for e in kern) / n_prof!r} kernels and {busy!r} device ms a "
          f"frame -> busy share {busy / med!r}; runtime calls a frame "
          f"{ {e.key: e.count / n_prof for e in ka if e.key in RUNTIME_CALLS} }", flush=True)
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        print(f"   {dev_us(e) / 1e3 / n_prof:10.4f} ms a frame  x{e.count:5d}  {e.key[:100]}")
    if name == "vo_rgbd_vga":
        from pyslam_tpu_torch.graph.core import FACTOR_KERNELS
        from pyslam_tpu_torch.pipelines.dense import _estimate_tdist_scale

        # one LM iteration's parts at level 0, at the pose of the last frame
        kf = pipe.keyframes[0]
        T = torch.as_tensor(pipe.T_c_w[-1] @ np.linalg.inv(kf.T_w), dtype=torch.float32).to(dev)
        data = pipe._level_data(kf.levels[0], pipe._track_pyramid(frames[n_prof + 2][0])[0])
        g = pipe._graph(T, data, pipe._level_loss(data, T))
        split = dense_split(g, pipe.options, dev, reps)
        split["photometric_kernel"] = host_ms(lambda: FACTOR_KERNELS[pipe._kind](data, T[None]), reps)
        split["tdist_scale"] = host_ms(lambda: _estimate_tdist_scale(data, T[None], 5.0, pipe._kind), reps)
        print(f"   host ms per call at level 0 (median of {reps}, synchronised): {split}", flush=True)


def online_cell(name, dev, dev_us, profiled=30):
    """The cells of chip_smoke's phases 32 to 35, f64 as the smoke holds
    them: one stream, the wall of each of its frames (keyframes, updates)
    on the host clock, each ending in the frame's read of the poses; the
    median and quartiles over the frames after the first ``profiled`` (the
    window fills there); then ``profiled`` more frames (the largest update
    of the incremental cell) under ``torch.profiler``: kernels and device
    ms per frame, busy share = device ms per frame over the unprofiled
    median (the incremental cell: over the profiled update's wall).  The VIO cell profiles a run over the trajectory's first 40
    keyframes, since its driver runs a trajectory to its end."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import m3500_data, vio_inputs
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import FixedLagLandmarkSmoother, FixedLagSmoother, IncrementalSmoother
    from pyslam_tpu_torch.solver import cuda_ops, linear
    from pyslam_tpu_torch.testing import fixed_lag_frames, fixed_lag_landmark_frames, incremental_updates
    from pyslam_tpu_torch.testing import vio_sliding_window

    f64 = torch.float64
    walls = []

    def timed(steps, k=None):
        """Run ``k`` steps of the iterator (all if None), each on the host clock."""
        n = 0
        while k is None or n < k:
            t0 = time.perf_counter()
            if next(steps, None) is None:
                break
            walls.append(1e3 * (time.perf_counter() - t0))
            n += 1
        return n

    cuda_ops.reset_launches()
    linear.reset_host_reads()
    if name == "vio_window":
        d, T = vio_inputs()
        stamps = [time.perf_counter()]
        vio_sliding_window(d, T, device=dev, on_keyframe=lambda *a: stamps.append(time.perf_counter()))
        walls.extend(1e3 * float(x) for x in np.diff(stamps))
        n = 41
        short = dataclasses.replace(d, T_gt=d.T_gt[:n], v_gt=d.v_gt[:n], omega=d.omega[: n - 1],
                                    accel=d.accel[: n - 1], dts=d.dts[: n - 1])

        def segment():
            vio_sliding_window(short, T[:n], device=dev)
            return n - 1
    elif name == "incremental_m3500":
        sm = IncrementalSmoother(kind="se2", device=dev)
        steps = incremental_updates(sm, m3500_data(), 250)
        timed(steps, 13)

        def segment():
            return timed(steps, 1)  # the 14th update: 3,500 poses, D = 14,130
    else:
        if name == "fixed_lag_sphere2500":
            sm = FixedLagSmoother(window=100, kind="se3", gn_iters=3, anchor_sqrt_info=1e4, dtype=f64, device=dev)
            steps, n_frames = fixed_lag_frames(sm, synth.se3_sphere(n_poses=2500, seed=0), 2500), 2499
        else:
            sm = FixedLagLandmarkSmoother(window=20, lm_slots=64, obs_kind="bearing_range_se2", kind="se2",
                                          gn_iters=3, dtype=f64, device=dev)
            data = synth.landmark_slam_2d(n_poses=800, n_landmarks=250, max_range=10.0, obs_type="bearing_range",
                                          odo_rot_std=0.005, seed=0)
            steps, n_frames = fixed_lag_landmark_frames(sm, data, 800), 799
        timed(steps, n_frames // 2)

        def segment():
            return timed(steps, profiled)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_frames = segment()
        torch.cuda.synchronize()
        pwall = 1e3 * (time.perf_counter() - t0)
    if name != "vio_window":
        del walls[-prof_frames:]
        if name == "incremental_m3500":
            timed(steps)
            t0 = time.perf_counter()
            sm.marginalize_oldest(keep_last=500)
            t_marg = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            sm.update()
            walls.append(1e3 * (time.perf_counter() - t0))
        else:
            timed(steps)
    steady = walls if name == "incremental_m3500" else walls[profiled:]
    q = statistics.quantiles(steady, n=4)
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kern) / 1e3
    # the share of a typical frame; the incremental cell profiles its largest
    # update, which only its own (profiled) wall measures
    per_frame_wall = pwall / prof_frames if name == "incremental_m3500" else statistics.median(steady)
    print(f"== {name}: wall per frame median of {len(steady)} {statistics.median(steady)!r} ms, quartiles {q[0]!r} to "
          f"{q[2]!r}, max {max(steady)!r}; launches of the whole stream {dict(cuda_ops.LAUNCHES)}, LM host reads "
          f"{linear.HOST_READS['lm']}", flush=True)
    print(f"   profiled {prof_frames} frames: wall {pwall!r} ms, device time summed {busy!r} ms ({busy / prof_frames!r} "
          f"ms a frame) -> busy share {busy / prof_frames / per_frame_wall!r}; kernels "
          f"{sum(e.count for e in kern)} ({sum(e.count for e in kern) / prof_frames!r} a frame)", flush=True)
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        print(f"   {dev_us(e) / 1e3:10.4f} ms  x{e.count:5d}  {e.key[:110]}")
    if name == "incremental_m3500":
        print(f"   marginalize_oldest(keep_last=500) {t_marg!r} ms", flush=True)


def sqrt_split(g, o, reps):
    """Host ms of the square-root path's parts at the start point: the plan,
    the linearization into buckets (``assemble_fn``) and one elimination and
    reduced solve (``solve_fn``), and the launches of one solve."""
    import torch

    from pyslam_tpu_torch.solver import cuda_ops, linear, schur_sqrt

    plan = schur_sqrt.build_sqrt_plan(g)
    assemble_fn, solve_fn = schur_sqrt._closures(plan, g.blocks["poses"].values.device)
    pieces, g0, _ = assemble_fn(g)
    lam = torch.tensor(o.lambda_init, dtype=g0.dtype, device=g0.device)
    cuda_ops.reset_launches()
    linear.reset_host_reads()
    schur_sqrt.solve_schur_sqrt(g, o, plan=plan)
    torch.cuda.synchronize()
    return dict(build_sqrt_plan=host_ms(lambda: schur_sqrt.build_sqrt_plan(g), reps),
                assemble_fn=host_ms(lambda: assemble_fn(g), reps),
                solve_fn=host_ms(lambda: solve_fn(pieces, g0, lam, o), reps),
                buckets=[tuple(m.shape) for _, _, m in plan.buckets],
                solve_counts=dict(cuda_ops.LAUNCHES, lm_reads=linear.HOST_READS["lm"]))


def make_cell(name, dev):
    """(graph, run) of one cell: ``run()`` solves and returns (solved, info)."""
    import torch

    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver.lm import Options

    if name in ("init_sphere2500", "gnc_sphere2500", "switch_m3500", "vio400"):
        return slice9_cell(name, dev)
    if name == "sqrt_ladybug":
        from pyslam_tpu_torch.io import bal
        from pyslam_tpu_torch.solver import solve_auto

        g = build.bal_graph(bal.perturbed(bal.synthetic_bal(49, 7000, seed=0, cam_cluster=0.05)), device=dev)
        o = Options(method="lm", max_iters=50)
        return g, o, lambda: solve_auto(g, o)

    if name == "sphere2500":
        from pyslam_tpu_torch.solver.bcsr import build_ell_direct, solve_ell

        g = build.pose_graph(synth.se3_sphere(n_poses=2500, seed=0), dtype=torch.float32, device=dev)
        plan = build_ell_direct(g)
        o = Options(method="lm", max_iters=30, min_cost_decrease=0.999)
        return g, o, lambda: solve_ell(g, o, plan=plan, pcg_rtol=3e-6, pcg_max_iters=120)

    if name in ("bcsr_sphere2500", "two_level_sphere2500"):
        from pyslam_tpu_torch.solver import bcsr

        g = build.pose_graph(synth.se3_sphere(n_poses=2500, seed=0), dtype=torch.float32, device=dev)
        o, pcg = Options(method="lm", max_iters=30, min_cost_decrease=0.999), dict(pcg_rtol=3e-6, pcg_max_iters=120)
        if name == "two_level_sphere2500":
            return g, o, lambda: bcsr.solve_ell(g, o, precond="two_level", **pcg)
        pattern = bcsr.build_pattern(g)
        return g, o, lambda: bcsr.solve_bcsr(g, o, pattern=pattern, spmv="ell", **pcg)

    if name in ("config4", "config4_dense"):
        from pyslam_tpu_torch.solver.schur import solve_schur

        g = build.ba_graph(synth.ba_synthetic(n_cams=49, n_pts=7000, seed=0), device=dev)
        o = Options(method="lm", max_iters=25)
        if name == "config4":
            return g, o, lambda: solve_schur(g, o, mode="pcg", pcg_rtol=1e-4, pcg_max_iters=30)
        return g, o, lambda: solve_schur(g, o, mode="dense")

    if name == "config8":
        from pyslam_tpu_torch.solver import solve_auto

        g = build.landmark_slam_2d(synth.landmark_slam_2d(n_poses=800, n_landmarks=250, max_range=10.0,
                                                          odo_rot_std=0.005, seed=0), device=dev)
        o = Options(method="lm", max_iters=30)
        return g, o, lambda: solve_auto(g, o)
    if name == "sparse_chol_5000":
        from pyslam_tpu_torch.solver import solve_auto

        g = build.pose_graph(synth.se2_manhattan(n_poses=5000, seed=1), device=dev)
        o = Options(method="gn", max_iters=30, min_cost_decrease=0.999)
        return g, o, lambda: solve_auto(g, o)
    if name == "schur_sparse_2000":
        from pyslam_tpu_torch.solver import solve_auto

        g = build.landmark_slam_2d(synth.landmark_slam_2d(n_poses=2000, n_landmarks=300, max_range=10.0,
                                                          odo_rot_std=0.005, seed=0), device=dev)
        o = Options(method="lm", max_iters=30)
        return g, o, lambda: solve_auto(g, o)
    if name == "fleet16":
        from pyslam_tpu_torch.solver import solve_batched

        fleet = [build.pose_graph(synth.se2_loop(n_poses=100, n_loops=12, seed=s), device=dev) for s in range(16)]
        o = Options(method="lm", max_iters=50)

        def run_fleet():
            _, chi2, info = solve_batched(fleet, o, return_info=True)
            return None, FleetInfo(chi2.sum(), max(info.iterations), info.status)

        return fleet[0], o, run_fleet

    from chip_smoke import m3500_data
    from pyslam_tpu_torch.losses import CauchyLoss
    from pyslam_tpu_torch.solver import solve

    if name == "config2_sparse_chol":
        from pyslam_tpu_torch.solver import sparse_chol

        g = build.pose_graph(m3500_data(), device=dev)
        o = Options(method="gn", max_iters=30, min_cost_decrease=0.999)
        plan = sparse_chol.build_chol_plan(g)
        return g, o, lambda: sparse_chol.solve_sparse_chol(g, o, plan=plan)
    if name == "config1":
        g = build.pose_graph(synth.se2_loop(n_poses=100, n_loops=12, seed=0), loss=CauchyLoss(2.0), device=dev)
        o = Options(method="lm", max_iters=50)
    elif name == "config2":
        g = build.pose_graph(m3500_data(), device=dev)
        o = Options(method="gn", max_iters=30, min_cost_decrease=0.999)
    elif name == "config7":
        data = synth.sim3_loop(n_poses=400, n_loops=10, scale_drift=0.005, odo_scale_std=0.005, seed=0)
        g = build.sim3_pose_graph(data, device=dev)
        o = Options(method="lm", max_iters=50)
    else:
        raise SystemExit(f"unknown cell {name!r}; cells: {', '.join(CELLS)}")
    return g, o, lambda: solve(g, o)


class LargeInfo(NamedTuple):
    """What the timing loop reads of a ``solve_schur_large`` solve."""

    chi2: object  # 0-dim tensor: the final chi2
    iterations: int  # accepted LM steps
    status: None


def large_cell(name, dev):
    """(graph, options, plan, common) of a ``solve_schur_large`` cell:
    Venice-mini (bench config 5's problem, PCG 1e-4 / 30, LM 15) or bench
    config 6 at full size (n_chunks 128, PCG 1e-4 / 12, LM 10)."""
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import schur_large
    from pyslam_tpu_torch.solver.lm import Options

    if name == "venice_mini":
        data = synth.ba_synthetic(n_cams=300, n_pts=60000, obs_per_pt=6, seed=0)
        o, common = Options(method="lm", max_iters=15), dict(n_chunks=16, pcg_rtol=1e-4, pcg_max_iters=30)
    else:
        t0 = time.perf_counter()
        data = synth.ba_synthetic(n_cams=1700, n_pts=1_000_000, obs_per_pt=5, seed=0)
        print(f"   config6 data generation {time.perf_counter() - t0!r} s", flush=True)
        o, common = Options(method="lm", max_iters=10), dict(n_chunks=128, pcg_rtol=1e-4, pcg_max_iters=12)
    g = build.ba_graph(data, device=dev)
    return g, o, schur_large.prepare_large_ba(g, common["n_chunks"]), common


def run_large(g, o, plan, common):
    from pyslam_tpu_torch.solver import schur_large

    _, chi2, hist = schur_large.solve_schur_large(g, o, plan=plan, **common)
    import torch

    return None, LargeInfo(torch.tensor(chi2), len(hist) - 1, None)


def large_split(name, g, o, plan, common, reps, run, cg_rounds=30):
    """Host ms of the phases of a ``solve_schur_large`` cell, one solve's
    counts, and the CG loop alone read every iteration against every fourth
    and never (``cg_rounds`` turns)."""
    import torch

    from pyslam_tpu_torch.solver import cuda_ops, linear, schur, schur_large
    from pyslam_tpu_torch.solver.cuda_ops import _stable_argsort, slot_plan

    pb, fb = g.blocks["poses"], g.batches[0]
    cam = fb.indices[0].cpu().numpy()
    pt = fb.indices[1].cpu().numpy()
    order = _stable_argsort(cam, pb.n)
    split = dict(
        indices_to_host=host_ms(lambda: (fb.indices[0].cpu().numpy(), fb.indices[1].cpu().numpy()), reps),
        argsort_by_camera=host_ms(lambda: _stable_argsort(cam, pb.n), reps),
        slot_plan_by_landmark=host_ms(lambda: slot_plan(pt[order], g.blocks["landmarks"].n), reps),
        prepare_large_ba=host_ms(lambda: schur_large.prepare_large_ba(g, common["n_chunks"]), reps),
        build_dense_pairs=host_ms(lambda: schur_large.build_dense_pairs(plan), 1),
    )
    lam = o.lambda_init
    rtol, max_iters = common["pcg_rtol"], common["pcg_max_iters"]
    parts = schur_large._linearize(plan, plan.poses, plan.lms)[1]
    Hll_inv, g_red, D, Hpp = schur_large._reduce(parts, lam, o.method)
    precond = schur.block_jacobi(schur._binv(schur._cholesky(D)))
    matvec = schur.schur_matvec(plan, Hpp, Hll_inv, parts["W"], parts["PP"])
    b = g_red.reshape(-1)
    x, it = pcg_guarded_plain(matvec, precond, b, rtol, max_iters)
    split.update(
        linearize=host_ms(lambda: schur_large._linearize(plan, plan.poses, plan.lms), reps),
        cost_only=host_ms(lambda: schur_large._cost(plan, plan.poses, plan.lms), reps),
        reduce=host_ms(lambda: schur_large._reduce(parts, lam, o.method), reps),
        block_inverse_of_D=host_ms(lambda: schur._binv(schur._cholesky(D)), reps),
        schur_product=host_ms(lambda: matvec(b), reps),
        pcg_loop=host_ms(lambda: schur_large._pcg(matvec, precond, b, rtol, max_iters), reps),
        pcg_iterations=int(it),
        back_substitute_and_retract=host_ms(
            lambda: schur_large._back_substitute_retract(parts, Hll_inv, plan.poses, plan.lms, x), reps),
    )
    # the CG loop alone on these inputs: the plain loop (a read an
    # iteration) against the masked loop read every 4th iteration and
    # never (always to the cap), in turns, the same iterate from each
    loops = {"plain, a read an iteration": pcg_guarded_plain,
             "masked, a read every 4": functools.partial(schur_large._pcg, read_every=4),
             "masked, never read": functools.partial(schur_large._pcg, read_every=0)}
    loop_ms = {label: [] for label in loops}
    for rep in range(cg_rounds + 1):  # round 0 warms up and is not kept
        for label, loop in loops.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xl, _ = loop(matvec, precond, b, rtol, max_iters)
            torch.cuda.synchronize()
            if rep:
                loop_ms[label].append(1e3 * (time.perf_counter() - t0))
            else:
                print(f"   CG loop [{label}]: |x - x_plain| {(xl - x).abs().max().item()!r}", flush=True)
    for label, w in loop_ms.items():
        q = statistics.quantiles(w, n=4)
        print(f"   CG loop alone [{label}]: median of {cg_rounds} {statistics.median(w)!r} ms, quartiles {q[0]!r} "
              f"to {q[2]!r}, least {min(w)!r}", flush=True)
    split["cg_loop_alone_ms"] = {label: statistics.median(w) for label, w in loop_ms.items()}
    del parts, Hll_inv, g_red, D, Hpp, precond, matvec
    cuda_ops.reset_launches()
    linear.reset_host_reads()
    schur_large.reset_cg_iterations()
    torch.cuda.reset_peak_memory_stats()
    run()
    split.update(slot_reduce_launches_per_solve=cuda_ops.LAUNCHES["slot_reduce"],
                 host_reads_per_solve=dict(linear.HOST_READS), cg_iterations=schur_large.cg_iterations(),
                 peak_memory_bytes=torch.cuda.max_memory_allocated())
    return split


# The temporary directory of the process group's ``file://`` store, removed
# after the group is destroyed at the end of ``main``.
_STORE = []


def one_rank_mesh(dev, axis_name):
    """A mesh over a process group of one rank on NCCL, the group started
    on first use over a ``file://`` store in a temporary directory."""
    import torch.distributed as tdist

    from pyslam_tpu_torch import dist

    if not tdist.is_initialized():
        _STORE.append(tempfile.TemporaryDirectory())
        dist.init_distributed(f"file://{os.path.join(_STORE[-1].name, 'world')}", world_size=1, rank=0, device=dev)
    return dist.make_mesh(axis_name=axis_name, device=dev)


def sharded_cell(dev, cm=False):
    """(graph, options, run) of bench config 5 on its own path: Venice-mini
    through ``dist.solve_schur_sharded`` (``dist.solve_schur_cm`` with
    ``cm``, 8 chunks) on a 1-rank NCCL mesh (PCG 1e-4 / 30, LM 15)."""
    from pyslam_tpu_torch import dist
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver.lm import Options

    mesh = one_rank_mesh(dev, "l")
    g = build.ba_graph(synth.ba_synthetic(n_cams=300, n_pts=60000, obs_per_pt=6, seed=0), device=dev)
    o = Options(method="lm", max_iters=15)

    def run():
        import torch

        solve = dist.solve_schur_cm if cm else dist.solve_schur_sharded
        _, chi2, hist = solve(g, mesh, o, pcg_rtol=1e-4, pcg_max_iters=30)
        return None, LargeInfo(torch.tensor(chi2), len(hist) - 1, None)

    return g, o, mesh, run


def precond_cells(dev, reps):
    """Bench config 6 through ``solve_schur_large`` with each
    preconditioner in turns, ``reps`` rounds after one warm-up round: the
    median and quartiles of each, its LM and CG iterations and chi2."""
    import torch

    from pyslam_tpu_torch.solver import schur_large

    g, o, plan, common = large_cell("config6", dev)
    t0 = time.perf_counter()
    plan.cpairs, plan.cpairs_G = schur_large.build_cluster_pairs(plan, 64, 4), 64
    t1 = time.perf_counter()
    plan.pairs = schur_large.build_dense_pairs(plan, 4)
    print(f"   precond_config6: cluster pairs {t1 - t0!r} s, dense pairs {time.perf_counter() - t1!r} s", flush=True)
    variants = {"jacobi": {}, "cluster64": dict(precond="cluster", cluster_size=64),
                "stale3": dict(precond="stale", stale_refresh=3)}
    walls = {k: [] for k in variants}
    for rnd in range(reps + 1):  # round 0 warms up and is not kept
        for k, kw in variants.items():
            schur_large.reset_cg_iterations()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, chi2, hist = schur_large.solve_schur_large(g, o, plan=plan, **kw, **common)
            torch.cuda.synchronize()
            if rnd:
                walls[k].append(1e3 * (time.perf_counter() - t0))
            else:
                print(f"   {k}: chi2 {chi2!r}, LM iterations {len(schur_large.cg_iterations())}, accepted "
                      f"{len(hist) - 1}, CG iterations {schur_large.cg_iterations()}", flush=True)
    for k, w in walls.items():
        q = statistics.quantiles(w, n=4) if len(w) > 1 else [w[0]] * 3
        print(f"== precond_config6 [{k}]: wall median of {len(w)} {statistics.median(w)!r} ms, quartiles {q[0]!r} "
              f"to {q[2]!r} (all {[round(x, 3) for x in w]})", flush=True)


def sharded_split(g, o, mesh, reps, run, cm=False):
    """Host ms of ``shard_ba`` (the plan), of one LM step at the start
    point with its CG budget of 30 and with none (their difference is the
    CG loop), and of one ``psum`` of the camera blocks and gradient; then
    one solve's counts: collectives, ``slot_reduce`` launches, host reads,
    CG iterations and peak memory."""
    import torch

    from pyslam_tpu_torch import dist
    from pyslam_tpu_torch.dist.schur_reduce import make_sharded_schur_step
    from pyslam_tpu_torch.solver import cuda_ops, linear, schur_large

    if cm:
        shard, make_step = (lambda: dist.shard_ba_cm(g, mesh, 8)), dist.make_cm_step
    else:
        shard, make_step = (lambda: dist.shard_ba(g, mesh)), make_sharded_schur_step
    sb = shard()
    state, lam = (sb.poses, sb.lms), o.lambda_init
    steps = {n: make_step(sb, o, 1e-4, n) for n in (30, 0)}
    cam = torch.zeros(sb.C * 42, dtype=sb.poses.dtype, device=sb.poses.device)
    split = dict(shard_ba=host_ms(shard, reps),
                 lm_step=host_ms(lambda: steps[30](state, lam), reps),
                 lm_step_without_cg=host_ms(lambda: steps[0](state, lam), reps),
                 psum_of_camera_blocks=host_ms(lambda: mesh.psum(cam), reps))
    cuda_ops.reset_launches()
    linear.reset_host_reads()
    schur_large.reset_cg_iterations()
    dist.reset_collectives()
    torch.cuda.reset_peak_memory_stats()
    run()
    split.update(collectives_per_solve=dict(dist.COLLECTIVES),
                 slot_reduce_launches_per_solve=cuda_ops.LAUNCHES["slot_reduce"],
                 host_reads_per_solve=dict(linear.HOST_READS), cg_iterations=schur_large.cg_iterations(),
                 peak_memory_bytes=torch.cuda.max_memory_allocated())
    return split


def sharded_cg_reads(dev, reps):
    """The sharded solvers on graphs whose CG stops well inside its budget,
    with the host reading the stop test never (``CG_READ_EVERY = 0``, what
    the solvers run: every linear solve pays its whole budget, a collective
    or three each iteration), every iteration and every 8th, in turns solve
    by solve after a warm-up round, on a 1-rank NCCL mesh (f32).  Per
    variant: the median wall with its quartiles, the CG iterations of each
    linear solve, the collectives of one solve, and the chi2, which must be
    the same bits under every variant (the frozen iterate is the one an
    early exit returns)."""
    import torch

    from pyslam_tpu_torch import dist
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import schur_large
    from pyslam_tpu_torch.solver.lm import Options

    mesh = one_rank_mesh(dev, "f")
    cases = {
        "solve_pose_sharded, se3_sphere(500), PCG 1e-4 / 250 (the default budget), LM 10": functools.partial(
            dist.solve_pose_sharded, build.pose_graph(synth.se3_sphere(n_poses=500, seed=0), device=dev), mesh,
            Options(method="lm", max_iters=10), pcg_rtol=1e-4),
        "solve_schur_sharded, config 4's graph, PCG 1e-4 / 200 (the default budget), LM 10": functools.partial(
            dist.solve_schur_sharded, build.ba_graph(synth.ba_synthetic(n_cams=49, n_pts=7000, seed=0), device=dev),
            mesh, Options(method="lm", max_iters=10), pcg_rtol=1e-4),
    }
    variants = (0, 1, 8)
    for label, solve in cases.items():
        walls, seen = {n: [] for n in variants}, {}
        try:
            for rep in range(reps + 1):  # round 0 warms up and is not kept
                for n in variants:
                    schur_large.CG_READ_EVERY = n
                    schur_large.reset_cg_iterations()
                    dist.reset_collectives()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, chi2, hist = solve()
                    wall = 1e3 * (time.perf_counter() - t0)
                    if rep:
                        walls[n].append(wall)
                    seen[n] = (chi2, len(hist) - 1, schur_large.cg_iterations(), dict(dist.COLLECTIVES))
        finally:
            schur_large.CG_READ_EVERY = 0
        print(f"== sharded CG reads: {label}", flush=True)
        for n in variants:
            q = statistics.quantiles(walls[n], n=4)
            chi2, accepted, cg, coll = seen[n]
            print(f"   read {'never' if n == 0 else f'every {n}'}: wall median of {reps} {statistics.median(walls[n])!r} "
                  f"ms, quartiles {q[0]!r} to {q[2]!r}; chi2 {chi2!r}, {accepted} accepted, CG iterations {cg}, "
                  f"collectives {coll}", flush=True)
        same = len({seen[n][0] for n in variants}) == 1
        print(f"   chi2 the same bits under every variant: {same}", flush=True)
        if not same:
            raise SystemExit(f"sharded CG reads: {label}: the variants' chi2 differ")


def block_idioms(dev):
    """Device ms of the Schur path's small block products at config 6's
    shapes (4,650,850 observations, 1,000,000 landmarks, 1,700 cameras; one
    linearization chunk of 36,335 observations), on random f32 blocks:
    batched ``@`` against the broadcast products summed over the short axis
    of ``schur.py`` (``_mv``, ``_tmv``, ``_mm``, ``_jtwj``), and Hll⁻¹ by
    ``schur._binv`` of ``_cholesky`` against the adjugate
    (``bcsr.sym_block_inv``), each pair on the same inputs."""
    import torch

    from chip_smoke import median_ms
    from pyslam_tpu_torch.solver import bcsr, schur

    M, L, C, n = 4_650_850, 1_000_000, 1700, 36_335
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    W, x_obs, t_obs, J, w = randn(M, 6, 3), randn(M, 3), randn(M, 6), randn(n, 3, 9), randn(n, 3).abs()
    A = randn(L, 3, 3)
    Hll = A @ A.transpose(1, 2) + 3.0 * torch.eye(3, device=dev)
    Hll_inv = bcsr.sym_block_inv(Hll)
    li = torch.randint(0, L, (M,), generator=gen, device=dev)
    pairs = {
        "W x (M, 6 x 3)": (lambda: (W @ x_obs[..., None])[..., 0], lambda: schur._mv(W, x_obs)),
        "W^T t (M, 6 x 3)": (lambda: (t_obs[:, None, :] @ W)[:, 0], lambda: schur._tmv(W, t_obs)),
        "Hll^-1 v (L, 3 x 3)": (lambda: (Hll_inv @ x_obs[:L, :, None])[..., 0], lambda: schur._mv(Hll_inv, x_obs[:L])),
        "W Hll^-1 W^T (M)": (lambda: W @ Hll_inv[li] @ W.transpose(1, 2),
                             lambda: schur._mm(schur._mm(W, Hll_inv[li]), W.transpose(1, 2))),
        "J^T w J (chunk, 3 x 9)": (lambda: J.transpose(1, 2) @ (w[..., None] * J), lambda: schur._jtwj(J, w, J)),
        "Hll^-1 (L, 3 x 3), Cholesky / adjugate": (lambda: schur._binv(schur._cholesky(Hll)),
                                                   lambda: bcsr.sym_block_inv(Hll)),
    }
    for label, (mm, bc) in pairs.items():
        t = [median_ms(f, (), calls=7) for f in (mm, bc, mm, bc)]
        print(f"   block idiom {label}: first (batched @ or Cholesky) {t[0]!r} / {t[2]!r} ms, second (broadcast or "
              f"adjugate) {t[1]!r} / {t[3]!r} ms", flush=True)


class FleetInfo(NamedTuple):
    """What the timing loop reads of a fleet solve."""

    chi2: object  # 0-dim tensor: the sum over the fleet
    iterations: int  # the fleet's LM iterations
    status: list


def sparse_split(name, g, o, dev, reps, run):
    """Host ms of the phases of the sparse cells, and one solve's counts."""
    import torch

    from pyslam_tpu_torch.solver import bcsr, cuda_ops, linear, schur, schur_sparse, sparse_chol

    lam = torch.tensor(o.lambda_init, dtype=next(iter(g.blocks.values())).values.dtype, device=dev)
    if name == "schur_sparse_2000":
        plan = schur_sparse.build_schur_sparse_plan(g)
        tables = schur_sparse.plan_tables(plan, dev)
        parts, gv, _ = schur.ba_assemble(g)
        Hpp, Hll_inv, W, g_red = schur._schur_reduce(parts, lam, o.method)
        He = schur_sparse.assemble_S_ell(plan, tables, Hpp, parts["PP"], W, Hll_inv)
        chol, rhs = plan.chol, g_red.reshape(-1)
        split = dict(
            build_schur_sparse_plan=host_ms(lambda: schur_sparse.build_schur_sparse_plan(g), reps),
            ba_assemble=host_ms(lambda: schur.ba_assemble(g, plan=parts["plan"]), reps),
            schur_reduce_and_Hll_inverse=host_ms(lambda: schur._schur_reduce(parts, lam, o.method), reps),
            assemble_S_ell=host_ms(lambda: schur_sparse.assemble_S_ell(plan, tables, Hpp, parts["PP"], W, Hll_inv),
                                   reps),
        )
        factor_args = (chol, He)
        dx = schur_sparse.schur_solve_sparse(parts, gv, lam, o, plan, tables)
    else:
        chol = sparse_chol.build_chol_plan(g)
        dplan = bcsr.ell_device_plan(chol.ell, dev)
        He, rhs, _ = bcsr.assemble_ell(g, dplan)
        split = dict(
            build_chol_plan=host_ms(lambda: sparse_chol.build_chol_plan(g), reps),
            ell_device_plan=host_ms(lambda: bcsr.ell_device_plan(chol.ell, dev), reps),
            assemble_ell=host_ms(lambda: bcsr.assemble_ell(g, dplan), reps),
        )
        factor_args = (chol, He, lam if o.method == "lm" else None)
        dx = sparse_chol.sparse_chol_solve(chol, He, rhs, lam, o)
    factors = sparse_chol._factorize(*factor_args)
    split.update(
        waves=len(chol.waves),
        factorize=host_ms(lambda: sparse_chol._factorize(*factor_args), reps),
        solve_factored=host_ms(lambda: sparse_chol._solve_factored(chol, factors, rhs), reps),
        retract_all=host_ms(lambda: g.retract_all(dx), reps),
    )
    cuda_ops.reset_launches()
    linear.reset_host_reads()
    _, info = run()
    info.chi2.item()
    split.update(slot_reduce_launches_per_solve=cuda_ops.LAUNCHES["slot_reduce"],
                 host_reads_per_solve=dict(linear.HOST_READS))
    return split


def dense_split(g, o, dev, reps):
    import torch

    from pyslam_tpu_torch.solver import assemble
    from pyslam_tpu_torch.solver.lm import _dense_solve

    plan = assemble.dense_plan(g)
    H, gv, _ = assemble.assemble_dense(g, plan)
    lam = torch.tensor(o.lambda_init, dtype=H.dtype, device=dev)
    dx = _dense_solve(H, gv, lam, o)
    return dict(
        dense_plan=host_ms(lambda: assemble.dense_plan(g), reps),
        linearize=host_ms(lambda: assemble.dense_contributions(g, hessian=True), reps),
        assemble_dense=host_ms(lambda: assemble.assemble_dense(g, plan), reps),
        cholesky_ex=host_ms(lambda: torch.linalg.cholesky_ex(H), reps),
        dense_solve=host_ms(lambda: _dense_solve(H, gv, lam, o), reps),
        retract_all=host_ms(lambda: g.retract_all(dx), reps),
    )


def ell_split(g, o, dev, reps):
    import torch

    from pyslam_tpu_torch.solver import bcsr, cuda_ops

    plan = bcsr.build_ell_direct(g)
    dplan = bcsr.ell_device_plan(plan, dev)
    He, gv, _ = bcsr.assemble_ell(g, dplan)

    def damp():
        D = He[:, 0]
        diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=1e-12)
        He_d = He.clone()
        He_d[:, 0] = D + o.lambda_init * torch.diag_embed(diag)
        return He_d, bcsr.sym_block_inv(He_d[:, 0])

    He_d, Minv = damp()
    if hasattr(cuda_ops, "ell_pcg"):
        def pcg():
            return cuda_ops.ell_pcg(He_d, dplan.cols, Minv, gv, 3e-6, 120).x
    else:  # before the ell_pcg kernel: the host loop of that solve_ell
        from pyslam_tpu_torch.solver.linear import pcg_solve

        def pcg():
            return pcg_solve(
                lambda x: cuda_ops.ell_matvec(He_d, dplan.cols, x), gv,
                precond=lambda r: (Minv @ r.reshape(plan.nb, plan.d, 1)).reshape(-1), rtol=3e-6, max_iters=120,
            )[0]

    if hasattr(cuda_ops, "ell_assemble"):
        args = bcsr.ell_assemble_args(g, dplan)
        inside = dict(ell_assemble=host_ms(lambda: cuda_ops.ell_assemble(*args), reps),
                      assemble_ell_general=host_ms(lambda: bcsr.assemble_ell_general(g, dplan), reps))
    else:  # before the ell_assemble kernel: linearization in tensor code, then two slot_reduce
        inside = dict(linearize=host_ms(lambda: bcsr.ell_contributions(g, plan), reps))

    dx = pcg()
    return dict(
        ell_device_plan=host_ms(lambda: bcsr.ell_device_plan(plan, dev), reps),
        assemble_ell=host_ms(lambda: bcsr.assemble_ell(g, dplan), reps),
        **inside,
        damp_and_block_inverse=host_ms(damp, reps),
        pcg_linear_solve=host_ms(pcg, reps),
        retract_all=host_ms(lambda: g.retract_all(dx), reps),
    )


def schur_split(g, o, dev, reps, run):
    import torch

    from pyslam_tpu_torch.solver import cuda_ops, linear, schur
    from pyslam_tpu_torch.solver.assemble import linearize_batch

    plan = schur.schur_plan(g)
    parts, gv, _ = schur.ba_assemble(g, plan=plan)
    lam = torch.tensor(o.lambda_init, dtype=gv.dtype, device=dev)
    Hpp, Hll_inv, W, g_red = schur._schur_reduce(parts, lam, o.method)
    dx = schur.schur_solve_dense(parts, gv, lam, o)
    dx_p = dx.reshape(-1)[: plan.C * plan.dp].reshape(plan.C, plan.dp)  # any vector of the shape will do

    loop_ms, loop_iterations = [], []
    loop = schur.pcg_solve

    def timed_loop(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, it = loop(*a, **kw)
        torch.cuda.synchronize()
        loop_ms.append(1e3 * (time.perf_counter() - t0))
        loop_iterations.append(int(it))
        return x, it

    def pcg_step():
        return schur.schur_solve_pcg(parts, gv, lam, o, rtol=1e-4, max_iters=30)

    schur.pcg_solve = timed_loop
    try:
        host_ms(pcg_step, reps)
    finally:
        schur.pcg_solve = loop
    cuda_ops.reset_launches()
    linear.reset_host_reads()
    _, info = run()
    info.chi2.item()
    counts = dict(slot_reduce_launches_per_solve=cuda_ops.LAUNCHES["slot_reduce"],
                  host_reads_per_solve=dict(linear.HOST_READS))
    return dict(
        schur_plan=host_ms(lambda: schur.schur_plan(g), reps),
        linearize=host_ms(lambda: [linearize_batch(fb, g.blocks) for fb in g.batches], reps),
        ba_assemble=host_ms(lambda: schur.ba_assemble(g, plan=plan), reps),
        schur_reduce=host_ms(lambda: schur._schur_reduce(parts, lam, o.method), reps),
        schur_solve_dense=host_ms(lambda: schur.schur_solve_dense(parts, gv, lam, o), reps),
        schur_solve_pcg=host_ms(pcg_step, reps),
        pcg_loop=statistics.median(loop_ms[1:]),
        pcg_loop_iterations=loop_iterations[-1],
        back_substitute=host_ms(lambda: schur._back_substitute(Hll_inv, W, plan, parts["g_l"], dx_p), reps),
        retract_all=host_ms(lambda: g.retract_all(dx), reps),
        **counts,
    )


def pcg_loop_variants(dev, reps):
    """Config 4 in 'pcg' mode under each way of running the CG loop."""
    import torch

    from pyslam_tpu_torch.solver import linear, schur

    g, o, run = make_cell("config4", dev)
    plain = schur.pcg_solve
    variants = [("plain loop, a read an iteration", plain)]
    variants += [(f"masked, a read every {n}" if n else "masked, never read (always to the cap)",
                  functools.partial(pcg_solve_masked, read_every=n)) for n in (1, 2, 5, 10, 0)]
    walls = {label: [] for label, _ in variants}
    try:
        for rep in range(reps + 1):  # round 0 warms each variant up and is not kept
            for label, loop in variants:
                schur.pcg_solve = loop
                linear.reset_host_reads()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, info = run()
                chi2 = info.chi2.item()
                wall = 1e3 * (time.perf_counter() - t0)
                if rep:
                    walls[label].append(wall)
                else:
                    print(f"== config4 pcg loop [{label}]: LM iterations {info.iterations} status {info.status} "
                          f"chi2 {chi2!r} accepted {info.accepted[: info.iterations].tolist()} "
                          f"host reads {dict(linear.HOST_READS)}", flush=True)
    finally:
        schur.pcg_solve = plain
    for label, w in walls.items():
        q = statistics.quantiles(w, n=4)
        print(f"== config4 pcg loop [{label}]: wall median of {reps} {statistics.median(w)!r} ms, quartiles "
              f"{q[0]!r} to {q[2]!r}, least {min(w)!r} (all {[round(x, 3) for x in w]})", flush=True)


def kernel_split(dev, dev_us, calls=50):
    """Mean device time of each kernel of sphere2500's assembly, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import bcsr, cuda_ops

    for dtype in (torch.float32, torch.float64):
        g = build.pose_graph(synth.se3_sphere(n_poses=2500, seed=0), dtype=dtype, device=dev)
        plan = bcsr.build_ell_direct(g)
        dplan = bcsr.ell_device_plan(plan, dev)
        h, gr, _ = bcsr.ell_contributions(g, plan)

        def once():
            bcsr.assemble_ell(g, dplan)
            cuda_ops.slot_reduce(h, dplan.h_perm, dplan.h_offsets, plan.nb * plan.K)
            cuda_ops.slot_reduce(gr, dplan.g_perm, dplan.g_offsets, plan.nb)

        once()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                once()
            torch.cuda.synchronize()
        print(f"== kernels, sphere2500 {dtype}: mean device us of {calls} calls")
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count == calls:
                print(f"   {dev_us(e) / e.count:10.3f} us  {e.key[:110]}")


def slot_sweep(dev, parent):
    """Device time of ``slot_reduce`` on random plans of 1,024 to 131,072
    destinations (at most 24M rows), widths 6 and 27: destinations drawn
    uniformly (64 to 2,736 rows each on average) and Zipf-distributed rows
    per destination (exponent 1.3, capped at 20,000 rows, the skew of
    bench config 6's pair plans); with ``--parent``, the parent
    checkout's ``slot_reduce`` beside (``parent_cuda_ops``)."""
    import numpy as np
    import torch

    from chip_smoke import median_ms, parent_cuda_ops
    from pyslam_tpu_torch.solver import cuda_ops

    old = parent_cuda_ops(parent) if parent else None
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    for n_slots in (1024, 1700, 4096, 8192, 16384, 32768, 65536, 131072):
        for rows in (64, 128, 300, 2736, "zipf"):
            if rows == "zipf":
                sizes = np.minimum(rng.zipf(1.3, n_slots), 20_000)
                dest = np.repeat(np.arange(n_slots), sizes)
                rng.shuffle(dest)
            else:
                dest = rng.integers(0, n_slots, n_slots * rows)
            E = len(dest)
            if E > 24_000_000:
                continue
            sp = cuda_ops.slot_plan(dest, n_slots)
            perm, off = torch.as_tensor(sp.perm, device=dev), torch.as_tensor(sp.offsets, device=dev)
            for C in (6, 27):
                x = torch.randn((E, C), generator=gen, device=dev)
                args = [x, perm, off, n_slots]
                body = cuda_ops.slot_reduce_body(E, n_slots, C, sp.longest)
                t = {f"this ({body})": median_ms(functools.partial(cuda_ops.slot_reduce, longest=sp.longest), args,
                                                 calls=7, inner=3)}
                if old:
                    t[f"parent ({old.slot_reduce_body(E, n_slots, C, sp.longest)})"] = median_ms(
                        functools.partial(old.slot_reduce, longest=sp.longest), args, calls=7, inner=3)
                print(f"   slot_sweep {n_slots} destinations, {rows} rows (E {E}, longest {int(np.diff(sp.offsets).max())}),"
                      f" width {C}: {t} ms", flush=True)


def rows_per_destination(offsets):
    """The distribution of a plan's rows per destination, as a dict: max,
    p99, p90, median, and the share of all rows that lie in destinations
    longer than 256, 1,024 and 4,096 rows."""
    import numpy as np

    n = np.diff(offsets.cpu().numpy().astype(np.int64))
    E = max(int(n.sum()), 1)
    return dict(destinations=len(n), rows=int(n.sum()), max=int(n.max()), p99=float(np.percentile(n, 99)),
                p90=float(np.percentile(n, 90)), median=float(np.median(n)),
                **{f"share_over_{k}": float(n[n > k].sum() / E) for k in (256, 1024, 4096)})


_CONFIG6 = []


def config6_cell(dev):
    """``large_cell("config6", dev)``, built once a process."""
    if not _CONFIG6:
        _CONFIG6.append(large_cell("config6", dev))
    return _CONFIG6[0]


def slot_pairs(dev, parent):
    """``slot_reduce`` at bench config 6's two pair plans (``cluster`` of
    64 cameras and ``stale``, the sums of ``chip_smoke.py``'s phase 50, 36
    wide, on seeded rows): the distribution of rows per destination, then
    the device time of this checkout's ``slot_reduce``, of the ``parent``
    checkout's (with ``--parent``), of ``index_add_`` and of the plain
    version, beside the bound."""
    import torch

    from chip_smoke import bound_ms, index_add_library, median_ms, parent_cuda_ops, tensor_bytes
    from pyslam_tpu_torch.solver import cuda_ops, schur_large

    _, _, plan, _ = config6_cell(dev)
    old = parent_cuda_ops(parent) if parent else None
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, build_pairs in (("cluster64", lambda: schur_large.build_cluster_pairs(plan, 64, 4)),
                              ("stale", lambda: schur_large.build_dense_pairs(plan, 4))):
        seg = build_pairs().by_block
        E = len(seg.perm)
        print(f"   slot_pairs {name}: rows per destination {rows_per_destination(seg.offsets)}", flush=True)
        x = torch.randn((E, 36), generator=gen, device=dev)
        args = [x, seg.perm, seg.offsets, seg.n_slots]
        ref = cuda_ops.slot_reduce_plain(*args)
        body = cuda_ops.slot_reduce_body(E, seg.n_slots, 36, seg.longest)
        variants = {f"this checkout ({body})": functools.partial(cuda_ops.slot_reduce, longest=seg.longest)}
        if old:
            variants[f"parent ({old.slot_reduce_body(E, seg.n_slots, 36, seg.longest)})"] = functools.partial(
                old.slot_reduce, longest=seg.longest)
        times = {}
        for label, fn in variants.items():
            err = (fn(*args) - ref).abs().max().item()
            times[label] = median_ms(fn, args, calls=7, inner=3)
            print(f"   slot_pairs {name} [{label}]: {times[label]!r} ms, max_abs_err {err!r}", flush=True)
        lib = index_add_library(*args)
        b_ms, by = bound_ms(tensor_bytes(x, seg.perm, seg.offsets, ref), x.numel())
        print(f"   slot_pairs {name}: {E} x 36 into {seg.n_slots}; index_add_ {median_ms(lib, (), calls=7, inner=3)!r} "
              f"ms, plain {median_ms(cuda_ops.slot_reduce_plain, args, calls=3)!r} ms, bound {b_ms!r} ms by {by}",
              flush=True)
        del x, ref, args, seg


def recorded_slot_calls(run):
    """Every distinct ``slot_reduce`` call of ``run()`` (one a plan and
    width): a list of (contrib, perm, offsets, n_slots, longest), recorded
    by ``chip_smoke.record_slot_reduce``."""
    from chip_smoke import record_slot_reduce

    calls = {}
    with record_slot_reduce(calls):
        run()
    return list(calls.values())


def slot_shape_calls(dev):
    """(label, calls) of the ``slot_reduce`` shapes of PERF.md's kernel
    table but the pair plans: sphere2500's general assembly (and its plan at
    the chordal rotation stage's width 81), one solve of each cell that
    sums with it (configs 1, 2, 7, 4, 8, Venice-mini, whose sums are those
    of ``schur_cm``'s one-rank plans, the BCSR and two-level paths, the
    square-root path), one VO frame, config 6's sums by camera and by
    landmark at phase 21's widths, and the benchmark's BAL sums by landmark
    (Venice's and BAL Final's, drawn and planned by their entries,
    ``chip_smoke.bal_cell``) at widths 3 and 9, on seeded rows."""
    import torch

    from chip_smoke import bal_cell
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.pipelines import DenseRGBDPipeline
    from pyslam_tpu_torch.sensors import RGBDCamera
    from pyslam_tpu_torch.solver import bcsr
    from pyslam_tpu_torch.testing import VO_CAM, vo_frames

    gen = torch.Generator(device=dev).manual_seed(0)
    g = build.pose_graph(synth.se3_sphere(n_poses=2500, seed=0), dtype=torch.float32, device=dev)
    plan = bcsr.build_ell_direct(g)
    dplan = bcsr.ell_device_plan(plan, dev)
    h, gr, _ = bcsr.ell_contributions(g, plan)
    sphere = [(h, dplan.h_perm, dplan.h_offsets, plan.nb * plan.K, dplan.h_longest),
              (gr, dplan.g_perm, dplan.g_offsets, plan.nb, dplan.g_longest)]
    yield "sphere2500", sphere
    yield "chordal 81", [(torch.randn((h.shape[0], 81), generator=gen, device=dev), dplan.h_perm, dplan.h_offsets,
                          plan.nb * plan.K, dplan.h_longest)]
    for name in ("config1", "config2", "config7", "config4", "config8", "bcsr_sphere2500", "two_level_sphere2500",
                 "sqrt_ladybug"):
        _, _, run = make_cell(name, dev)
        yield name, recorded_slot_calls(run)
    g_vm, o_vm, plan_vm, common_vm = large_cell("venice_mini", dev)
    yield "venice_mini", recorded_slot_calls(lambda: run_large(g_vm, o_vm, plan_vm, common_vm))
    frames = vo_frames(3)
    pipe = DenseRGBDPipeline(RGBDCamera(**VO_CAM), pyrlevels=4, keyframe_trans_thresh=1e9, device=dev)
    pipe.track(*frames[0])
    yield "vo_rgbd_vga", recorded_slot_calls(lambda: pipe.track(*frames[1]))
    _, _, plan6, _ = config6_cell(dev)
    n_obs = len(plan6.by_cam.perm)
    for label, seg, width in (("camera", plan6.by_cam, 27), ("camera", plan6.by_cam, 21), ("camera", plan6.by_cam, 6),
                              ("landmark", plan6.by_lm, 9), ("landmark", plan6.by_lm, 3)):
        yield f"config6 by {label}", [(torch.randn((n_obs, width), generator=gen, device=dev), seg.perm, seg.offsets,
                                       seg.n_slots, seg.longest)]
    for config in ("venice_ba", "bal_final13682"):
        seg = bal_cell(config, 0, dev)[2].pop("plan").by_lm  # the rest of the plan and the graph go here
        torch.cuda.empty_cache()
        yield f"{config} by landmark", [(torch.randn((len(seg.perm), width), generator=gen, device=dev), seg.perm,
                                         seg.offsets, seg.n_slots, seg.longest) for width in (3, 9)]
        del seg


def slot_shapes(dev, parent, rounds=4):
    """``slot_reduce`` at every shape of ``slot_shape_calls``: the device
    time of 20 calls back to back of this checkout's ``slot_reduce`` and,
    with ``--parent``, of the parent checkout's (``parent_cuda_ops``: its
    own wrapper, body rule and kernels), in turns (parent, this, this,
    parent, ...; ``rounds`` of each, each the median of 5 measurements),
    with each side's spread (largest less smallest) and body, whether the
    two give the same bits, and ``index_add_``'s time and the bound
    beside.  A shape whose body changed, or where this side is slower than
    the parent by more than the larger spread, is marked."""
    import torch

    from chip_smoke import bound_ms, index_add_library, median_ms, parent_cuda_ops, tensor_bytes
    from pyslam_tpu_torch.solver import cuda_ops

    old = parent_cuda_ops(parent) if parent else None
    for label, calls in slot_shape_calls(dev):
        for contrib, perm, offsets, n_slots, longest in calls:
            args = [contrib.float().contiguous(), perm, offsets, n_slots]
            E, C = args[0].shape
            sides = {"this": functools.partial(cuda_ops.slot_reduce, longest=longest)}
            bodies = {"this": cuda_ops.slot_reduce_body(E, n_slots, C, longest)}
            if old:
                sides["parent"] = functools.partial(old.slot_reduce, longest=longest)
                bodies["parent"] = old.slot_reduce_body(E, n_slots, C, longest)
            ref = cuda_ops.slot_reduce_plain(*args)
            outs = {}
            for side, fn in sides.items():
                outs[side] = fn(*args)
                err = (outs[side] - ref).abs().max().item()
                assert err <= 1e-5 * max(ref.abs().max().item(), 1e-30), (label, side, err)
            times = {k: [] for k in sides}
            for rnd in range(rounds):
                for side in list(sides)[::1 if rnd % 2 else -1]:
                    times[side].append(1e3 * median_ms(sides[side], args, calls=5, inner=20))
            lib_us = 1e3 * median_ms(index_add_library(*args), (), calls=5, inner=20)
            b_ms, by = bound_ms(tensor_bytes(*args[:3], ref), contrib.numel())
            line = "  ".join(f"{k} ({bodies[k]}) {statistics.median(v)!r} us (spread {max(v) - min(v)!r})"
                             for k, v in times.items())
            if old:
                med = {k: statistics.median(v) for k, v in times.items()}
                spread = max(max(v) - min(v) for v in times.values())
                line += (f"; bits {'equal' if torch.equal(outs['this'], outs['parent']) else 'differ'}"
                         f"{'; BODY CHANGED' if bodies['this'] != bodies['parent'] else ''}"
                         f"{'; SLOWER beyond the spread' if med['this'] - med['parent'] > spread else ''}")
            n = offsets[1:] - offsets[:-1]
            print(f"   slot_shapes {label} {tuple(contrib.shape)} into {n_slots} (longest {int(n.max()) if n_slots else 0}"
                  f" rows): {line}; index_add_ {lib_us!r} us; bound {1e3 * b_ms!r} us by {by}", flush=True)
            del outs, ref, args


def parent_library(parent):
    """The kernel library of the checkout at ``parent``: its ``_ext.py``
    loaded as a module of its own, the library built from its sources into
    its own ``build/``; (module, library)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_parent_ext", os.path.join(parent, "pyslam_tpu_torch", "_ext.py"))
    ext = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ext)
    return ext, ext.library()


def pcg_callers(parent):
    """``ell_pcg``'s kernel alone, this checkout's and (with ``parent``) the
    parent checkout's, each called with its own conventions on buffers made
    once: {side: prepare(He, cols, Minv, B (n, m), rtol, max_iters) ->
    (launch(), result())}, launch() one launch that counts nothing,
    result() (x (n, m), iterations (m,)).  The parent takes b and x as
    (m, n) and scratch of 3 m n + 3 grid m values (its layout before the
    carrying barriers); this checkout (n, mp) and ``pcg_scratch_values``."""
    import ctypes

    import torch

    from pyslam_tpu_torch._ext import library
    from pyslam_tpu_torch.solver import cuda_ops

    def prepare_with(lib, layout_this):
        def prepare(He, cols, Minv, B, rtol, max_iters):
            nb, K, d, _ = He.shape
            n, m = B.shape
            out = (ctypes.c_int * 6)()
            err = lib.pyslam_ell_pcg_plan(nb, K, d, He.element_size(), m, out)
            if err:
                raise RuntimeError(f"pyslam_ell_pcg_plan: {err}")
            if layout_this:
                mp = cuda_ops.pcg_layout_columns(m, He.dtype)
                bk = B.new_zeros((n, mp))
                bk[:, :m] = B
                n_scratch = cuda_ops.pcg_scratch_values(n, mp, out[0], He.dtype)
            else:
                bk = B.t().contiguous()
                n_scratch = 3 * m * n + 3 * out[0] * m
            xk = torch.empty_like(bk)
            scratch = torch.empty(n_scratch, dtype=He.dtype, device=He.device)
            its = torch.empty(m, dtype=torch.int32, device=He.device)
            counter = torch.zeros(1, dtype=torch.int64, device=He.device)
            fn = getattr(lib, f"pyslam_ell_pcg_{'f64' if He.dtype is torch.float64 else 'f32'}")
            stream = torch.cuda.current_stream(He.device).cuda_stream
            args = (He.data_ptr(), cols.data_ptr(), Minv.data_ptr(), bk.data_ptr(), xk.data_ptr(), scratch.data_ptr(),
                    its.data_ptr(), counter.data_ptr(), nb, K, d, m, rtol, max_iters, stream)

            def launch(keep=(bk, xk, scratch, its, counter)):  # the buffers live as long as the launch
                err = fn(*args)
                if err:
                    raise RuntimeError(f"ell_pcg: error {err}")

            def result():
                return (xk[:, :m] if layout_this else xk.t()).clone(), its.clone()

            return launch, result

        return prepare

    sides = {"this": prepare_with(library(), True)}
    if parent:
        sides["parent"] = prepare_with(parent_library(parent)[1], False)
    return sides


def pcg_systems(dev):
    """(label, He, cols, Minv, B, rtol, max_iters) of ``ell_pcg`` at the
    shapes of PERF.md's kernel table: sphere2500's first LM system (damped
    at lambda_init, f32 and f64, m = 1, rtol 3e-6, cap 120: the main path's
    linear solve); the first GN systems of the chordal rotation stages
    (undamped, f32, rtol 1e-6, cap 250) of sphere2500 (d = 9) and of config
    2's graph (d = 4); sphere2500's undamped covariance system at the
    ground truth (f64, rtol 1e-10, cap 2000) with 36 unit columns at poses
    spread over the graph (phase 37's block before the carrying barriers:
    6 poses) and with one; and the non-resident plan, a random
    block-diagonally dominant ELL system of 30,000 rows of 6 (f32, m = 1,
    rtol 1e-5, cap 200: He does not fit in shared memory), built as the
    card tests build theirs."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.graph import build, initialize
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver.bcsr import assemble_ell, build_ell_direct, ell_device_plan, sym_block_inv
    from pyslam_tpu_torch.solver.lm import Options

    data = synth.se3_sphere(n_poses=2500, seed=0)
    g = build.pose_graph(data, dtype=torch.float32, device=dev)
    plan = build_ell_direct(g)
    dplan = ell_device_plan(plan, dev)
    He, b, _ = assemble_ell(g, dplan)
    He[:, 0] += Options().lambda_init * torch.diag_embed(
        torch.clamp(torch.diagonal(He[:, 0], dim1=-2, dim2=-1), min=1e-12))
    for dtype in (torch.float32, torch.float64):
        A = He.to(dtype).contiguous()
        yield (f"sphere2500 damped {str(dtype)[6:]} m=1", A, dplan.cols, sym_block_inv(A[:, 0]).contiguous(),
               b.to(dtype)[:, None].contiguous(), 3e-6, 120)
    for name, dset in (("sphere2500 d=9", data), ("config2 d=4", synth.se2_manhattan(3500, seed=1))):
        d = dset.dim
        R_meas = np.asarray(dset.T_meas, np.float64)[:, :d, :d]
        g_rot = initialize._rotation_graph(dset.edges_i, dset.edges_j, R_meas, dset.T_gt.shape[0], 0, np.eye(d),
                                           torch.float32, dev)
        rplan = ell_device_plan(build_ell_direct(g_rot), dev)
        Hr, gr, _ = assemble_ell(g_rot, rplan)
        yield f"chordal {name} m=1", Hr, rplan.cols, sym_block_inv(Hr[:, 0]).contiguous(), gr[:, None].contiguous(), \
            1e-6, 250
    g64 = build.pose_graph(data, dtype=torch.float64, device=dev)
    g64 = g64.with_values({"poses": dataclasses.replace(g64.blocks["poses"], values=torch.as_tensor(
        data.T_gt, dtype=torch.float64, device=dev))})
    He64, _, _ = assemble_ell(g64, dplan)
    Minv64 = sym_block_inv(He64[:, 0]).contiguous()
    n = plan.nb * 6
    for m in (36, 1):
        B = torch.zeros((n, m), dtype=torch.float64, device=dev)
        B[(torch.arange(m, device=dev) * 389 % plan.nb) * 6 + torch.arange(m, device=dev) % 6,
          torch.arange(m, device=dev)] = 1.0
        yield f"covariance f64 m={m}", He64, dplan.cols, Minv64, B, 1e-10, 2000
    # the non-resident plan: tests/test_torch_cuda.py's _spd_ell at 30,000 x 9 x 6 (rows coupled at four random
    # offsets, each pair stored as a block and its transpose, the diagonal blocks dominant)
    rng = np.random.default_rng(6)
    nb, K, d = 30000, 9, 6
    Hn = np.zeros((nb, K, d, d))
    rows = np.arange(nb)
    cols = np.tile(rows.astype(np.int32)[:, None], (1, K))
    for j, o in enumerate(rng.choice(np.arange(1, nb), size=(K - 1) // 2, replace=False)):
        blk = 0.3 * rng.normal(size=(nb, d, d))
        Hn[rows, 1 + 2 * j], cols[rows, 1 + 2 * j] = blk, (rows + o) % nb
        Hn[(rows + o) % nb, 2 + 2 * j], cols[(rows + o) % nb, 2 + 2 * j] = blk.transpose(0, 2, 1), rows
    A = rng.normal(size=(nb, d, d))
    Hn[:, 0] = A @ A.transpose(0, 2, 1) + (1.0 + np.abs(Hn[:, 1:]).sum((1, 2, 3)))[:, None, None] * np.eye(d)
    Hn = torch.from_numpy(Hn).to(dev, torch.float32)
    yield ("non-resident 30000x9x6 f32 m=1", Hn, torch.from_numpy(cols).to(dev), torch.linalg.inv(Hn[:, 0]).contiguous(),
           torch.from_numpy(rng.normal(size=(nb * d, 1))).to(dev, torch.float32), 1e-5, 200)


def pcg_phase_library():
    """A copy of ``csrc/ell_pcg.cu`` with clock64() marks between the phases
    of an iteration, built into ``build/pcg_phases/`` at the package's
    flags: thread 0 of every block adds the cycles since the last mark to
    its block's row of a device array (eight phases), which
    ``pyslam_debug_phases(out, reset)`` copies out or zeroes.  The marks
    sit at block barriers, so a phase counts the block's wait for its
    slowest thread, and a barrier phase the wait for the slowest block."""
    import ctypes
    import shutil

    from pyslam_tpu_torch import _ext

    src = open(os.path.join(os.path.dirname(_ext.__file__), "csrc", "ell_pcg.cu")).read()

    def mark(k):
        return ("if (threadIdx.x == 0) { const long long now = clock64(); "
                f"g_phase_cycles[blockIdx.x * 8 + {k}] += now - phase_last; phase_last = now; }}\n")

    def at(anchor, text, before=False):
        nonlocal src
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, text + anchor if before else anchor + text)

    at("namespace {\n\nconstexpr int kThreads", "__device__ long long g_phase_cycles[256 * 8];\n", before=True)
    # one column: 0 the p update and the product, 1 the first barrier, 2 the
    # vector updates and the arrival, 3 the second barrier's poll
    at("  while (sqrt_t(rr) > tol && it < a.max_iters) {", "  long long phase_last = clock64();\n", before=True)
    at("\n    T v = T(0);", "\n" + mark(0).rstrip("\n"), before=True)
    at("    barrier_sums<T, 1, false>(a.slots1, G, epoch, bc, pap);\n", mark(1))
    at("    barrier_sums<T, 2, false>(a.slots2, G, epoch, bc, sums);\n", mark(2), before=True)
    at("    barrier_sums<T, 2, false>(a.slots2, G, epoch, bc, sums);\n", mark(3))
    # a block of columns: 7 the lists, 0 the p update, 1 the product, 2 the
    # first barrier, 3 the vector items, 4 the second barrier's arrival and
    # the owners' sums, 6 the totals' poll
    at("  for (;;) {\n", "  long long phase_last = clock64();\n", before=True)
    at("    if (n_run == 0) break;\n", mark(7))
    at("    // Ap, and the row's share of p.Ap, of item (lr, group)", mark(0), before=True)
    at("    // first barrier: p.Ap of every running column", mark(1), before=True)
    at("    vector_items(false);\n", mark(2), before=True)
    at("    vector_items(false);\n    __syncthreads();\n", mark(3))
    at("    own_totals<T, 2, true>(a.slots2, a.tot2, act_s, m, epoch, warp, lane);\n", mark(4))
    at("    if (warp < n_run) fence_gpu();  // acquire: the next product reads the others' z and p\n", mark(6))
    src += ('\nextern "C" int pyslam_debug_phases(void* out, int reset) {\n'
            '  static long long zero[256 * 8];\n'
            '  return reset ? (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero))\n'
            '               : (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(zero));\n}\n')
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "pcg_phases")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ell_pcg.cu"), "w") as f:
        f.write(src)
    shutil.copy(os.path.join(os.path.dirname(_ext.__file__), "csrc", "ell_row.cuh"), out_dir)
    lib_path = os.path.join(out_dir, "libpcg_phases.so")
    cmd = [_ext._nvcc(), *_ext._ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", lib_path,
           os.path.join(out_dir, "ell_pcg.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed: {proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _ext._SIGNATURES.items():
        if name.startswith("pyslam_ell_pcg"):
            getattr(lib, name).argtypes = argtypes
    lib.pyslam_debug_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def pcg_phases(lib, prepare, B):
    """The phase split of one launch of the traced library (``prepare`` as
    ``pcg_callers`` makes it): the mean over blocks of each phase's cycles,
    as shares of their sum, and the launch's iterations."""
    import torch

    launch, result = prepare
    buf = torch.zeros(256 * 8, dtype=torch.int64)
    launch()
    torch.cuda.synchronize()
    lib.pyslam_debug_phases(None, 1)
    launch()
    torch.cuda.synchronize()
    lib.pyslam_debug_phases(buf.data_ptr(), 0)
    grid = torch.cuda.get_device_properties(B.device).multi_processor_count
    cycles = buf.view(256, 8)[:grid].double().mean(0)
    return (cycles / cycles.sum()).tolist(), max(result()[1].tolist())


def pcg_columns(dev, reps, parent):
    """``ell_pcg``'s kernel alone at every shape of ``pcg_systems``, this
    checkout's and, with ``--parent``, the parent checkout's in turns
    (parent, this, this, parent, ...; ``reps`` rounds, at least 9, one
    launch between CUDA events a measurement, after a warm-up): the median,
    the spread (largest less smallest) and µs an iteration of the launch,
    and whether x and the counts equal the parent's bit for bit (else the
    largest difference of x relative to its largest entry).  Then one
    barrier of each kind alone, 2,000 in a launch at a grid of one block a
    SM (``pyslam_ell_pcg_barrier_probe``: the parent's ``grid.sync()`` and
    read of the partial sums, against the carrying barrier with its fences,
    as the second barrier of an iteration, and without, as the first), f32
    and f64,
    in turns; the phase split of one launch of sphere2500's solve and of
    the 36-column block (``pcg_phase_library``); and
    ``torch.cholesky_solve`` of the 36 covariance columns on the dense H's
    factor (its factorization not timed)."""
    import torch

    from pyslam_tpu_torch._ext import library
    from pyslam_tpu_torch.solver import cuda_ops
    from pyslam_tpu_torch.solver.assemble import unit_diag_where_dead_

    def event_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    sides = pcg_callers(parent)
    cov = None
    for label, He, cols, Minv, B, rtol, max_iters in pcg_systems(dev):
        runs = {side: prep(He, cols, Minv, B, rtol, max_iters) for side, prep in sides.items()}
        times = {side: [] for side in runs}
        for launch, _ in runs.values():
            launch()
        torch.cuda.synchronize()
        for rnd in range(reps):
            for side in list(runs)[::1 if rnd % 2 else -1]:
                times[side].append(event_ms(runs[side][0]))
        x, its = runs["this"][1]()
        iters = max(its.tolist())
        line = "  ".join(f"{k} {1e3 * statistics.median(v)!r} us (spread {1e3 * (max(v) - min(v))!r}; "
                         f"{1e3 * statistics.median(v) / max(iters, 1)!r} us an iteration)" for k, v in times.items())
        if "parent" in runs:
            xp, itsp = runs["parent"][1]()
            same = torch.equal(x, xp) and torch.equal(its, itsp)
            diff = ((x - xp).abs().max() / xp.abs().max().clamp(min=1e-300)).item()
            line += (f"; bits {'equal' if same else 'differ'} to the parent's (x rel {diff!r}, iterations "
                     f"{'equal' if torch.equal(its, itsp) else f'{its.tolist()} against {itsp.tolist()}'})")
        print(f"   ell_pcg {label} ({tuple(B.shape)}, launch iterations {iters}): {line}", flush=True)
        if label.startswith("covariance") and B.shape[1] == 36:
            cov = (He, cols, B)
        del runs

    traced = pcg_phase_library()
    names = {1: ("p update and product", "first barrier", "vector updates and arrival", "second barrier"),
             36: ("p update", "product", "first barrier", "vector items", "second arrival and owners' sums", "",
                  "totals' poll", "list")}
    from pyslam_tpu_torch import _ext

    for label, He, cols, Minv, B, rtol, max_iters in pcg_systems(dev):
        if label not in ("sphere2500 damped float32 m=1", "covariance f64 m=36"):
            continue
        saved, _ext.library = _ext.library, lambda: traced
        try:
            prepare = pcg_callers(None)["this"](He, cols, Minv, B, rtol, max_iters)
        finally:
            _ext.library = saved
        shares, iters = pcg_phases(traced, prepare, B)
        split = ", ".join(f"{n} {100 * f:.1f}%" for n, f in zip(names[B.shape[1]], shares) if n)
        print(f"   ell_pcg {label}: phase split of a traced launch ({iters} iterations, mean over blocks): {split}",
              flush=True)
        del prepare

    lib = library()
    G = torch.cuda.get_device_properties(dev).multi_processor_count
    rounds = 2000
    for dtype in (torch.float32, torch.float64):
        scratch = torch.zeros(1 << 17, dtype=dtype, device=dev)
        out = torch.zeros(1, dtype=dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def probe(kind):
            err = lib.pyslam_ell_pcg_barrier_probe(out.element_size(), kind, rounds, scratch.data_ptr(),
                                                    out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"pyslam_ell_pcg_barrier_probe: {err}")

        kinds = {0: "grid.sync() + read", 1: "carrying, fenced", 2: "carrying, no fence"}
        times = {kind: [] for kind in kinds}
        for kind in kinds:
            probe(kind)
        for rnd in range(reps):
            for kind in list(kinds)[::1 if rnd % 2 else -1]:
                times[kind].append(1e3 * event_ms(lambda: probe(kind)) / rounds)
        line = "; ".join(f"{name} {statistics.median(times[k])!r} us (spread {max(times[k]) - min(times[k])!r})"
                         for k, name in kinds.items())
        print(f"   barrier alone, {G} blocks of 512 threads, two {str(dtype)[6:]} values a block: {line}", flush=True)

    He, cols, B = cov
    nb, K, d, _ = He.shape
    n = nb * d
    H = torch.zeros((n, n), dtype=torch.float64, device=dev)
    rows = torch.arange(nb, device=dev)
    for k in range(K):
        H.view(nb, d, nb, d)[rows, :, cols[:, k].long(), :] += He[:, k]
    unit_diag_where_dead_(H)
    L, info = torch.linalg.cholesky_ex(H)
    del H
    torch.cholesky_solve(B, L)
    t = sorted(event_ms(lambda: torch.cholesky_solve(B, L)) for _ in range(reps))
    print(f"   torch.cholesky_solve of the 36 covariance columns (info {int(info)}): {1e3 * statistics.median(t)!r} us "
          f"(spread {1e3 * (t[-1] - t[0])!r})", flush=True)


def assemble_shapes(dev):
    """(label, graph) of ``ell_assemble`` at the shapes of PERF.md: the
    sphere2500 of config 3 and the 30,000-pose sphere of the card tests
    (``se3_sphere(seed=0)``), and the stress graph under a Cauchy loss
    (special angles, priors, padding, a frozen interior pose), each in f32
    and f64; and in f64 ``testing.se3_pair_graph``, whose slots sum several
    factors of one pose pair, in one batch both ways."""
    import torch

    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.losses import CauchyLoss
    from pyslam_tpu_torch.testing import se3_pair_graph, se3_stress_graph

    for n_poses in (2500, 30000):
        data = synth.se3_sphere(n_poses=n_poses, seed=0)
        for dtype in (torch.float32, torch.float64):
            yield f"sphere{n_poses} {str(dtype)[6:]}", build.pose_graph(data, dtype=dtype, device=dev)
    for dtype in (torch.float32, torch.float64):
        yield f"stress_cauchy {str(dtype)[6:]}", se3_stress_graph(loss=CauchyLoss(2.0), dtype=dtype, device=dev)
    yield "pairs float64", se3_pair_graph(loss=CauchyLoss(2.0), device=dev)


def parent_assemble(parent, g, dev):
    """The parent checkout's ``ell_assemble`` kernel on ``g`` through its C
    entry, the slot-grained kernel's signature (the Hessian slot plan's
    ``entries`` and offsets, scratch of 84 values a factor and a chi2
    partial every 32 factors), its buffers made once: (launch(), (He, g,
    chi2))."""
    import ctypes

    import numpy as np
    import torch

    from pyslam_tpu_torch.solver import bcsr, cuda_ops

    lib = parent_library(parent)[1]
    plan = bcsr.build_ell_direct(g)
    hp, _ = bcsr.build_slot_plans(plan)
    idx, codes, first = [], [], [0]
    for batch_entries in plan.maps:  # the parent's build_assemble_tables
        slots = {a: np.asarray(pos_ab, np.int64) // plan.K for a, b, pos_ab, _ in batch_entries if a == b}
        factor = first[-1] + np.arange(len(slots[0]), dtype=np.int64)
        idx.append(np.stack([slots[0], slots[len(slots) - 1]], axis=1))
        for a, b, _, pos_ba in batch_entries:
            codes.append(factor << 3 | a << 2 | b << 1)
            if pos_ba is not None:
                codes.append(factor << 3 | a << 2 | b << 1 | 1)
        first.append(first[-1] + len(factor))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)

    idx, entries, offsets = t(np.concatenate(idx)), t(np.concatenate(codes)[hp.perm]), t(hp.offsets)
    cols = t(plan.cols)
    block = next(iter(g.blocks.values()))
    batches = bcsr.ell_assemble_batches(g)
    n, dtype, nb, K = len(batches), block.values.dtype, plan.nb, plan.K
    codes = [cuda_ops.kernel_loss(bt.loss) for bt in batches]
    tables = [(ctypes.c_void_p * n)(*[getattr(bt, k).data_ptr() for bt in batches])
              for k in ("T_obs", "sqrt_info", "weight")]
    tables += [(ctypes.c_int * (n + 1))(*first), (ctypes.c_int * n)(*[bt.n_slots for bt in batches]),
               (ctypes.c_int * n)(*[c[0] for c in codes]), (ctypes.c_double * (3 * n))(*[v for c in codes for v in c[1:]])]
    He = torch.empty((nb, K, 6, 6), dtype=dtype, device=dev)
    gv = torch.empty(nb * 6, dtype=dtype, device=dev)
    chi2 = torch.empty((), dtype=dtype, device=dev)
    scratch_len = first[-1] * 84 + -(-first[-1] // 32)
    scratch = torch.empty(scratch_len, dtype=dtype, device=dev)
    fn = getattr(lib, f"pyslam_ell_assemble_{'f64' if dtype is torch.float64 else 'f32'}")
    args = (block.values.data_ptr(), block.const_mask.data_ptr(), cols.data_ptr(), idx.data_ptr(), entries.data_ptr(),
            offsets.data_ptr(), n, *(ctypes.addressof(x) for x in tables), scratch.data_ptr(), scratch_len,
            He.data_ptr(), gv.data_ptr(), chi2.data_ptr(), nb, K, torch.cuda.current_stream(dev).cuda_stream)

    def launch(keep=(tables, idx, entries, offsets, cols, scratch)):  # the buffers live as long as the launch
        err = fn(*args)
        if err:
            raise RuntimeError(f"parent ell_assemble: error {err}")

    return launch, (He, gv, chi2)


def assemble_cell(dev, dev_us, reps, parent, calls=20):
    """``ell_assemble`` alone at every shape of ``assemble_shapes``: this
    checkout's wrapper and, with ``--parent``, the parent checkout's kernel
    (``parent_assemble``) in turns (parent, this, this, parent, ...;
    ``reps`` rounds, at least 9).  A round times each side's call alone
    (one call between CUDA events) and back to back (``calls`` calls
    between events, over ``calls``), each behind a hold of the stream so
    that the host has queued everything before the first event fires:
    medians and spreads (largest less smallest).  Then each side under
    ``torch.profiler`` (``calls`` calls): the mean device µs of every kernel
    by name, the stages apart; the wrapper's host µs a call (its checks,
    ctypes tables and allocations, ``calls`` calls queued without a
    synchronisation, median of 5); whether He, g and chi2 equal the
    parent's bit for bit (else the largest difference relative to the
    largest entry), and the compiler's registers and spills of each side's
    assembly kernels; then the phase split of this checkout's stages
    (``assemble_phases``) at sphere2500 and the 30,000-pose sphere."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pyslam_tpu_torch import _ext
    from pyslam_tpu_torch.solver import bcsr, cuda_ops

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        queue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(max(1_000_000, int(4 * queue_s * 2e9)))  # longer than the host takes to queue the calls
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return 1e3 * start.elapsed_time(end) / n

    def spread(v):
        return f"{statistics.median(v)!r} (spread {max(v) - min(v)!r})"

    for label, g in assemble_shapes(dev):
        dplan = bcsr.ell_device_plan(bcsr.build_ell_direct(g), dev)
        args = bcsr.ell_assemble_args(g, dplan)
        sides = {"this": (lambda: cuda_ops.ell_assemble(*args), None)}
        if parent:
            sides["parent"] = parent_assemble(parent, g, dev)
        out = {}
        for side, (fn, bufs) in sides.items():
            res = fn()
            torch.cuda.synchronize()
            out[side] = [x.clone() for x in (bufs or res)]
        single = {side: [] for side in sides}
        b2b = {side: [] for side in sides}
        for rnd in range(reps):
            for side in list(sides)[::1 if rnd % 2 else -1]:
                single[side].append(timed(sides[side][0], 1))
                b2b[side].append(timed(sides[side][0], calls))
        line = "; ".join(f"{side} single {spread(single[side])} b2b {spread(b2b[side])}" for side in sides)
        print(f"   assemble {label} (nb {dplan.host.nb}, K {dplan.host.K}, factors {dplan.a_idx.shape[0]}), us, "
              f"{reps} rounds: {line}", flush=True)
        for side, (fn, _) in sides.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            split = ", ".join(f"{e.key[:60]} {dev_us(e) / e.count!r}" for e in kern if e.count == calls)
            print(f"   assemble {label} {side}: device us a call by kernel: {split}", flush=True)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                cuda_ops.ell_assemble(*args)
            host.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
        print(f"   assemble {label}: the wrapper's host us a call {spread(host)}", flush=True)
        if parent:
            diffs = []
            for name, a, b in zip(("He", "g", "chi2"), out["this"], out["parent"]):
                same = torch.equal(a, b)
                rel = ((a - b).abs().max() / b.abs().max().clamp(min=1e-300)).item()
                where = ""
                if name == "He" and not same:  # which blocks: diagonal, off-diagonal
                    blocks = (a != b).flatten(2).any(-1)
                    where = f", {int(blocks[:, 0].sum())} diagonal and {int(blocks[:, 1:].sum())} off-diagonal blocks"
                elif name == "g" and not same:
                    where = f", {int((a != b).view(-1, 6).any(-1).sum())} rows"
                diffs.append(f"{name} {'equal' if same else f'differ (rel {rel!r}{where})'}")
            print(f"   assemble {label}: bits against the parent's: {', '.join(diffs)}", flush=True)
        del sides, out
    assemble_phases(dev, ("sphere2500 float32", "sphere2500 float64", "sphere30000 float32"))
    logs = {"this": _ext.BUILD_INFO.get("log") or ""}
    if parent:
        logs["parent"] = parent_library(parent)[0].BUILD_INFO.get("log") or ""
    for side, text in logs.items():
        for chunk in text.split("Compiling entry function ")[1:]:
            fn_name = chunk.split("'")[1]
            if re.search(r"assemble|linearize_kernel|(?<!slot_)reduce_kernelI", fn_name):
                info = "; ".join(line.split(":", 1)[-1].strip() for line in chunk.splitlines()
                                 if "stack frame" in line or "Used" in line)
                print(f"   ptxas {side} {fn_name}: {info}", flush=True)


def assemble_phase_library():
    """A copy of ``csrc/ell_assemble.cu`` with clock64() marks between the
    phases of each stage, built into ``build/assemble_phases/`` at the
    package's flags: thread 0 of every stage-1 block and lane 0 of every
    stage-2 warp add the cycles since their last mark to a device array
    (``pyslam_debug_assemble_phases(out, reset)`` copies it out or zeroes
    it).  Stage 1: 0 the loads and the pose algebra, 1 the rows of sqrt_info
    (J_0, J_1, w, w r), 2 chi2, 10 the records' copy; stage 2, lane 0 of
    every warp: 4 the prologue and the wait for stage 1, 5 the entries and
    the staged records, 6 the parts, 7 the ordered sums, 8 the masks and the
    stores; 3 and 9 count the blocks and the warps.  Each block adds to the
    row of counters of its index modulo 256, so that few marks meet on one
    address."""
    import ctypes
    import shutil

    from pyslam_tpu_torch import _ext

    src = open(os.path.join(os.path.dirname(_ext.__file__), "csrc", "ell_assemble.cu")).read()

    def mark(k, who):  # 256 rows of counters, one by block index modulo 256, so that few marks meet
        return (f"if ({who}) {{ const long long now = clock64(); "
                f"atomicAdd(&g_phase_cycles[(blockIdx.x % 256) * 16 + {k}], "
                "(unsigned long long)(now - phase_last)); phase_last = now; }\n")

    def at(anchor, text, before=False):
        nonlocal src
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, text + anchor if before else anchor + text)

    one, lead = "threadIdx.x == 0", "lane == 0"
    at("namespace {\n\nconstexpr int kMaxBatches", "__device__ unsigned long long g_phase_cycles[256 * 16];\n", before=True)
    at("  T fw = T(0);\n", "  long long phase_last = clock64();\n"
       "  if (threadIdx.x == 0) atomicAdd(&g_phase_cycles[(blockIdx.x % 256) * 16 + 3], 1ull);\n")
    at("    T tR[9];  // t^ R of the adjoint", "    " + mark(0, one), before=True)
    at("  __syncthreads();\n  if (sub == 0) {  // the factor's chi2", "  " + mark(1, one), before=True)
    at("  // the block's records, one contiguous run of the scratch", "  " + mark(2, one), before=True)
    at("  launch_dependents();\n}", "  " + mark(10, one), before=True)
    at("  if (r >= nb) return;  // a whole warp leaves together\n",
       "  long long phase_last = clock64();\n"
       "  if (threadIdx.x % 32 == 0) atomicAdd(&g_phase_cycles[(blockIdx.x % 256) * 16 + 9], 1ull);\n")
    at("  wait_for_previous_grid();\n\n  for (int u0", "  " + mark(4, lead), before=True)
    at("      // every part of the chunk's entries, a lane a row", "      " + mark(5, lead), before=True)
    at("      // then each unit's sum, in entry order", "      " + mark(6, lead), before=True)
    at("      __syncwarp();\n    }\n#pragma unroll\n    for (int j = 0; j < kUnitsPerLane; ++j) {", "      " + mark(7, lead),
       before=True)
    at("        for (int t = 0; t < 6; ++t) g[6LL * r + t] = -acc[j][t] * free_r;\n      }\n    }\n  }\n",
       "  " + mark(8, lead))
    src += ('\nextern "C" int pyslam_debug_assemble_phases(void* out, int reset) {\n'
            '  static unsigned long long zero[256 * 16];\n'
            '  return reset ? (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero))\n'
            '               : (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(zero));\n}\n')
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "assemble_phases")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ell_assemble.cu"), "w") as f:
        f.write(src)
    lib_path = os.path.join(out_dir, "libassemble_phases.so")
    cmd = [_ext._nvcc(), *_ext._ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", lib_path,
           os.path.join(out_dir, "ell_assemble.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed: {proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _ext._SIGNATURES.items():
        if name.startswith("pyslam_ell_assemble"):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.pyslam_debug_assemble_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def assemble_phases(dev, shapes):
    """The phase split of one ``ell_assemble`` call of the traced library
    at each of ``shapes`` (labels of ``assemble_shapes``): the mean cycles a
    stage-1 block and a stage-2 warp spend in each phase."""
    import torch

    from pyslam_tpu_torch import _ext
    from pyslam_tpu_torch.solver import bcsr, cuda_ops

    lib = assemble_phase_library()
    names = {0: "loads and pose algebra", 1: "rows", 2: "chi2", 10: "records' copy", 4: "prologue and wait",
             5: "entries and records", 6: "parts", 7: "ordered sums", 8: "masks and stores"}
    for label, g in assemble_shapes(dev):
        if label not in shapes:
            continue
        args = bcsr.ell_assemble_args(g, bcsr.ell_device_plan(bcsr.build_ell_direct(g), dev))
        saved, _ext.library = _ext.library, lambda: lib
        try:
            cuda_ops.ell_assemble(*args)  # warm
            torch.cuda.synchronize()
            lib.pyslam_debug_assemble_phases(None, 1)
            cuda_ops.ell_assemble(*args)
            torch.cuda.synchronize()
        finally:
            _ext.library = saved
        buf = torch.zeros(256 * 16, dtype=torch.int64)
        lib.pyslam_debug_assemble_phases(buf.data_ptr(), 0)
        c = buf.view(256, 16).sum(0).tolist()
        split = ", ".join(f"{n} {c[k] / max(c[3 if k in (0, 1, 2, 10) else 9], 1):.0f}" for k, n in names.items())
        print(f"   assemble {label}: mean cycles a stage-1 block ({c[3]}) / stage-2 warp ({c[9]}) by phase: {split}",
              flush=True)


def bal_rows_cell(dev, reps, parent=None, calls=20):
    """``bal_rows`` alone at Venice's and at BAL Final's size (the module
    docstring)."""
    import json

    import torch

    from portbench.entries import schur_large as venice_entry
    from portbench.entries import schur_large_bal9 as final_entry
    from portbench.generators import bal_scene, bal_scene9
    from pyslam_tpu_torch import _ext
    from pyslam_tpu_torch.solver import cuda_ops, schur_large

    old = parent_library(parent)[1] if parent else None
    shapes = (("venice_ba", venice_entry, bal_scene, (torch.float32, torch.float64)),
              ("bal_final13682", final_entry, bal_scene9, (torch.float32,)))
    for config, entry, generator, dtypes in shapes:
        cfg = json.loads(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench", "configs",
                                           f"{config}.json")).read())
        problem = generator.generate(cfg["sizes"], 1, dev)
        for dtype in dtypes:
            state = entry.build(problem, dict(cfg, dtype=str(dtype)[6:]), dev)
            entry.plan(state)
            plan = state["plan"]
            args = schur_large.bal_rows_args(plan, plan.poses, plan.lms)
            chunk = plan.Mp // plan.n_chunks
            M, C, L = plan.M, plan.C, plan.L

            def event_ms(fn, n):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(n):
                    fn()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / n

            def rows_call():
                return cuda_ops.bal_rows(*args, plan.loss)

            def cost_call():
                return cuda_ops.bal_rows(*args, plan.loss, rows=False)

            a = rows_call()
            # each input byte once (indices, obs, weight, sqrt_info, f, k1, k2
            # where passed; the camera and landmark tables), each output byte
            # once (rows at their width, cost)
            nbytes = sum(t.numel() * t.element_size() for t in (*args, *a) if t is not None)
            bound_ms = nbytes / 3.35e12 * 1e3
            sides = {"this": rows_call}
            if old is not None and plan.dp == 6:
                fn = getattr(old, f"pyslam_bal_rows_{'f32' if dtype is torch.float32 else 'f64'}")
                code = cuda_ops.kernel_loss(plan.loss)
                per_obs = int(args[8].dim() == 3)

                def parent_call(fn=fn, code=code, per_obs=per_obs):
                    cost = torch.empty(M, dtype=dtype, device=dev)
                    out = torch.empty((M, 54), dtype=dtype, device=dev)
                    err = fn(*(t.data_ptr() for t in args[:9]), per_obs, args[9].data_ptr(), code[0], *code[1:], M,
                             cost.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
                    assert err == 0, err
                    return cost, out

                sides["parent"] = parent_call
            for fn in sides.values():
                fn(), cost_call()
            t = {f"{side} {k}": [] for side in sides for k in ("single", "b2b")}
            t.update({"cost single": [], "cost b2b": []})
            order = list(sides.items())
            for r in range(reps):
                for side, fn in (order if r % 2 == 0 else order[::-1]):  # in turns: parent, this, this, parent
                    t[f"{side} single"].append(event_ms(fn, 1))
                    t[f"{side} b2b"].append(event_ms(fn, calls))
                t["cost single"].append(event_ms(cost_call, 1))
                t["cost b2b"].append(event_ms(cost_call, calls))
            b = rows_call()
            bits = ""
            if "parent" in sides:
                p = sides["parent"]()
                bits = f"; the parent's bits {torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])}"
                del p
            plain_ms = event_ms(lambda: cuda_ops.bal_rows_plain(*args, plan.loss, chunk=chunk), 1)
            ref = cuda_ops.bal_rows_plain(*args, plan.loss, chunk=chunk)
            scale = cuda_ops.bal_rows_scale(*args, plan.loss, chunk=chunk)[0]
            err = ((a[1] - ref[1]).abs() / scale.clamp(min=1e-30).to(dtype)).max().item()
            err_cost = ((a[0] - ref[0]).abs().max() / ref[0].abs().max()).item()
            del ref
            torch.cuda.empty_cache()
            # the chunked path the kernel replaces, in turns with the kernel
            chunked = dataclasses.replace(plan, bal=False)
            chunked_ms, kernel_ms = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                schur_large._obs_rows(chunked, plan.poses, plan.lms)
                torch.cuda.synchronize()
                chunked_ms.append(1e3 * (time.perf_counter() - t0))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                schur_large._obs_rows(plan, plan.poses, plan.lms)
                torch.cuda.synchronize()
                kernel_ms.append(1e3 * (time.perf_counter() - t0))
            times = ", ".join(f"{k} {statistics.median(v)!r} ms (spread {max(v) - min(v)!r})" for k, v in t.items())
            print(f"bal_rows {config} {plan.dp} dof {str(dtype)[6:]} M={M} C={C} L={L}: {times}; bound "
                  f"{bound_ms!r} ms ({nbytes} B); b2b at {100 * bound_ms / statistics.median(t['this b2b']):.1f}% "
                  f"of it; plain twin {plain_ms!r} ms; in turns, host clock: chunked path (128 chunks) "
                  f"{statistics.median(chunked_ms)!r} ms {chunked_ms!r} against the kernel's _obs_rows "
                  f"{statistics.median(kernel_ms)!r} ms {kernel_ms!r}; repeat bitwise "
                  f"{torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])}{bits}; largest difference from the twin: "
                  f"rows {err!r} (of each column's largest sum of term magnitudes), cost {err_cost!r} (of the "
                  "largest)", flush=True)
            del state, plan, args, a, b, chunked
            torch.cuda.empty_cache()
        del problem
    log_file = os.path.join(os.path.dirname(_ext.BUILD_INFO.get("path", "")), "ptxas.log")  # cached or not
    log = open(log_file).read().splitlines() if os.path.isfile(log_file) else []
    regs, entry = [], None
    for line in log:  # each entry function's name, then its "Used N registers" line
        if "Compiling entry function" in line:
            entry = line if "bal_rows" in line else None
        elif entry is not None and "Used" in line:
            regs.append(f"{entry.split(chr(39))[1][:60]}: {line.split(':', 1)[-1].strip()}")
    print("   ptxas (bal_rows):", " | ".join(regs) or f"no {log_file}", flush=True)

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--parent", default=None,
                    help="a checkout whose kernels the slot cells, pcg_columns, assemble and bal_rows time beside")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is False: no GPU to run on", file=sys.stderr)
        return 1
    import pyslam_tpu_torch  # noqa: F401  (sets the TF32 flags)

    dev = pyslam_tpu_torch.default_device() if hasattr(pyslam_tpu_torch, "default_device") else torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"({smi.stdout.strip() or 'nvidia-smi not available'}); "
          f"pyslam_tpu_torch from {os.path.dirname(pyslam_tpu_torch.__file__)}", flush=True)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    for name in args.cells.split(","):
        if name == "kernels":
            kernel_split(dev, dev_us)
            continue
        if name == "config4_pcg_loops":
            pcg_loop_variants(dev, args.reps)
            continue
        if name == "slot_sweep":
            slot_sweep(dev, args.parent)
            continue
        if name == "slot_pairs":
            slot_pairs(dev, args.parent)
            continue
        if name == "slot_shapes":
            slot_shapes(dev, args.parent)
            continue
        if name == "block_idioms":
            block_idioms(dev)
            continue
        if name == "pcg_columns":
            pcg_columns(dev, max(args.reps, 9), args.parent)
            continue
        if name == "assemble":
            assemble_cell(dev, dev_us, max(args.reps, 9), args.parent)
            continue
        if name == "bal_rows":
            bal_rows_cell(dev, max(args.reps, 9), args.parent)
            continue
        if name == "sharded_cg_reads":
            sharded_cg_reads(dev, max(args.reps, 9))
            continue
        if name in ONLINE_CELLS:
            online_cell(name, dev, dev_us)
            continue
        if name in VO_CELLS:
            vo_cell(name, dev, dev_us, args.reps)
            continue
        reps = args.reps
        if name in ("venice_mini", "config6"):
            t0 = time.perf_counter()
            g, o, plan, common = large_cell(name, dev)
            print(f"   {name}: graph and plan {time.perf_counter() - t0!r} s", flush=True)
            run = functools.partial(run_large, g, o, plan, common)
        elif name in ("config5", "schur_cm_config5"):
            g, o, mesh, run = sharded_cell(dev, cm=name == "schur_cm_config5")
        elif name == "precond_config6":
            precond_cells(dev, args.reps)
            continue
        else:
            g, o, run = make_cell(name, dev)
        if name in MIN_NINE:
            reps = max(reps, 9)
        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _, info = run()
            chi2 = info.chi2.item()
            walls.append(1e3 * (time.perf_counter() - t0))
        wall = statistics.median(walls)
        quartiles = statistics.quantiles(walls, n=4) if len(walls) > 1 else [wall] * 3
        print(f"== {name}: wall median of {reps} {wall!r} ms, quartiles {quartiles[0]!r} to {quartiles[2]!r} (all "
              f"{[round(w, 3) for w in walls]}); LM iterations {info.iterations} status {info.status} chi2 {chi2!r}",
              flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, info = run()
            info.chi2.item()
            pwall = 1e3 * (time.perf_counter() - t0)
        ka = prof.key_averages()
        kern = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(dev_us(e) for e in kern) / 1e3
        print(f"   profiled wall {pwall!r} ms; device time summed {busy!r} ms -> busy share {busy / wall!r}; "
              f"kernels launched per solve {sum(e.count for e in kern)}")
        print(f"   runtime calls per solve {({e.key: e.count for e in ka if e.key in RUNTIME_CALLS})}")
        for e in sorted(kern, key=dev_us, reverse=True)[:10]:
            print(f"   {dev_us(e) / 1e3:10.4f} ms  x{e.count:5d}  {e.key[:110]}")
        if name in ("config5", "schur_cm_config5"):
            split = sharded_split(g, o, mesh, reps, run, cm=name == "schur_cm_config5")
        elif name in ("venice_mini", "config6"):
            split = large_split(name, g, o, plan, common, min(args.reps, 3) if name == "config6" else args.reps, run)
        elif name == "sphere2500":
            split = ell_split(g, o, dev, args.reps)
        elif name in ("bcsr_sphere2500", "two_level_sphere2500"):
            from pyslam_tpu_torch.solver import schur_large

            schur_large.reset_cg_iterations()
            run()
            split = dict(cg_iterations=schur_large.cg_iterations())
        elif name.startswith("config4") or name == "config8":
            split = schur_split(g, o, dev, args.reps, run)
        elif name in ("config2_sparse_chol", "sparse_chol_5000", "schur_sparse_2000"):
            split = sparse_split(name, g, o, dev, args.reps, run)
        elif name == "fleet16":
            continue
        elif name in ("init_sphere2500", "gnc_sphere2500", "switch_m3500", "vio400"):
            split = slice9_split(name, g, o, dev, args.reps)
        elif name == "sqrt_ladybug":
            split = sqrt_split(g, o, args.reps)
        else:
            split = dense_split(g, o, dev, args.reps)
        print(f"   host ms per call (median of {args.reps}, synchronised): {split}", flush=True)
    import torch.distributed as tdist

    if tdist.is_initialized():
        tdist.destroy_process_group()
    for store in _STORE:
        store.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
