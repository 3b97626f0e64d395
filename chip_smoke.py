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
  * bench config 4, bundle adjustment of ``ba_synthetic(49, 7000)`` (stereo
    reprojection factors) through ``build.ba_graph`` + ``solve_schur``, LM,
    in ``mode="pcg"`` (PCG 1e-4 / 30) and in ``mode="dense"``;
    each of the last four with the 1% gate of ``bench/run.py`` on the
    converged cost in ``bench/standin_cache.json``;
  * small graphs through ``solve_schur``, for coverage: a BAL graph with
    optimized intrinsics (the ``bal_cam9`` block) and 2D landmark SLAM in
    both observation types; the cost must fall below a tenth of its start;
  * bench config 8, ``landmark_slam_2d(800, 250)`` through
    ``build.landmark_slam_2d`` + ``solve_auto`` (route ``schur_dense``),
    LM, under its 1% gate;
  * ``solve_sparse_chol`` (the multifrontal sparse Cholesky) on config 2's
    graph and options, against the dense path's chi2 (1e-4 relative) and
    bit for bit against a second run, with ``slot_reduce`` checked at every
    wave's forward-solve plan; ``solve_auto`` on ``se2_manhattan(5000)``
    (15,000 dof, route ``sparse_chol``) against the dense ``solve``;
  * ``solve_auto`` on ``landmark_slam_2d(2000, 300)`` (route
    ``schur_sparse``) against ``solve_schur(mode="dense")``, with
    ``slot_reduce`` checked at the plan of S;
  * ``solve_batched`` on a fleet of 16 ``se2_loop(100)`` graphs against 16
    single solves (chi2 1e-4 relative in f32; in f64 the same LM
    iterations, stop codes and accept sequences, chi2 1e-10 relative);
  * small f64 cross-checks of the card's path against the CPU path;
  * Venice-mini (bench config 5's problem, ``ba_synthetic(300, 60000,
    obs_per_pt=6)``) through ``solve_schur_large``: f32 PCG 1e-4 / 30 and
    LM 15 under 1.001 x ``venice_mini_ref``, f32 ``linear="dense"``, and
    f64 ``linear="dense"`` with the settings that produced that reference
    (``scripts/venice_mini_ref.py``), within 1e-6 of it;
  * bench config 6 at full size (1,700 cameras, 1,000,000 points, 4,650,850
    observations; n_chunks 128, PCG 1e-4 / 12, LM 10) through
    ``prepare_large_ba`` + ``solve_schur_large`` after a one-iteration
    warm-up, under 1.001 x ``venice_full_conv``, with ``route_auto`` naming
    ``schur_large`` and ``solve_auto`` running it; ``slot_reduce`` at its
    sums by camera and by landmark, against the plain version and a second
    run; its data generation takes 30 to 50 s of host numpy;
  * the multi-device layer (``dist/``) on a process group of one rank over
    NCCL (a ``file://`` store in a temporary directory): bench config 5,
    Venice-mini through ``solve_schur_sharded`` (PCG 1e-4 / 30, LM 15)
    under 1.001 x ``venice_mini_ref`` and within 1e-4 of
    ``solve_schur_large``; sphere2500 through ``solve_pose_sharded`` under
    its gate, its CG products the ``ell_matvec`` kernel; ``slot_reduce`` at
    the plans of both (config 5's sums by camera and by landmark, the
    pose-sharded assembly's Hessian blocks and gradient rows); config 7
    through ``solve_factor_parallel`` within 1e-4 of the dense path;
    ``ell_matvec`` at the sharded shape (rank 0 of 2 of sphere2500 against
    the whole x);
    and two ranks spawned on the one card over gloo (NCCL refuses two ranks
    on one GPU), config 4's graph and a 500-pose sphere each within 1e-4 of
    one rank;
  * initialization (phase 28): sphere2500 and config 2's graph at the
    'odometry', 'spanning_tree' and 'chordal' inits, each init's chi2
    within 1e-3 of the JAX reference's, then the cell's solve from it under
    the cell's gate; ``ell_pcg`` and ``slot_reduce`` at the chordal
    rotation stages (9-dof and 4-dof blocks);
  * GNC (phase 29): ``solve_gnc`` on sphere2500 with 100 wrong loop
    closures (``solve_auto`` -> ``ell``): the reference's planted rejects,
    its inlier mask on all but 0.5% of the edges, chi2 within 1e-3;
  * switchable loop closures (phase 30): config 2's graph with 100 wrong
    loops, 508 switches, LM 60: in f64 the reference's switches below 0.5
    and its chi2 within 1e-3, in f32 every planted switch below 0.5;
    ``slot_reduce`` at the dense groups of 3-slot factors;
  * VIO (phase 31): 400 keyframes of ``examples/vio.py``'s trajectory
    through EuRoC files, ``vio_graph`` in f64 and LM 60: chi2 within 1e-8
    of the reference's in its LM iterations, the example's velocity and
    gyro-bias bounds, the batched preintegration against the per-interval
    one within 1e-12;
    each with a small f64 cross-check of the card against the CPU path;
  * online and marginalized estimation (phases 32 to 36), each against the
    JAX reference's numbers (``REF_*`` and ``chip_smoke_refs.npz``, by the
    same script): the sliding-window VIO of
    ``examples/vio_sliding_window.py`` over phase 31's trajectory (its
    first 100 keyframes, all 399 when the phase is selected; window 5,
    ``marginalize`` of the oldest triple; f64, the newest pose's error
    within 1e-9 at every keyframe) and over the
    example's own 16 keyframes (its three asserts); ``FixedLagSmoother``
    over sphere2500 (window 100; f64 within 1e-8 at every pose as it leaves
    the window, then f32) and ``FixedLagLandmarkSmoother`` over bench
    config 8's graph (window 20, 64 landmark slots: the reference's 186
    retirements in order), a GN step of each made with synchronizing calls
    as errors; ``IncrementalSmoother`` over config 2's stream (an update
    every 250 poses, then ``marginalize_oldest(keep_last=500)``: the
    reference's chi2 and LM iterations at every update, its ``compiles``);
    ``solve_auto`` through the ``schur_sqrt`` route on a Ladybug-49-size
    monocular low-parallax graph (f64 within 1e-8 of the reference's
    ``solve_schur_sqrt``, f32 beside ``solve_schur``'s dense mode), with
    ``slot_reduce`` at that route's shapes; small f64 cross-checks of the
    card against the CPU path;
  * posterior covariance and the repaired fleet solve (phases 37 to 42),
    in f64: the multi-column ``ell_pcg`` against its plain version at
    sphere2500's shapes (m = 1, 12 and the plan's maximum, f32 and f64,
    two runs the same bits) and timed against m single-column launches,
    the plain version and ``torch.cholesky_solve``; sphere2500's pose
    marginals at phase 4's estimate (the dense inverse as referee for the
    selected inverse of all 2,500 poses, 1e-9, and PCG columns of 256
    poses, 1e-6; the odometry cross blocks; ``factor_logdet`` against
    ``slogdet``) and at the ground truth against the JAX reference
    (1e-9); ``bench/covariance_bench.py``'s M3500 case (plan,
    factorization, the sweep, 16 column solves held to it and to the
    reference); bench config 4's covariances by ``pcg`` and ``sparse``
    against its dense inverse, and Venice-mini's (whose dense inverse does
    not fit) by both against each other and the reference; the sharded
    marginals on the one-rank NCCL mesh (phase 40); the incremental
    smoother's ``pose_marginals`` in its three branches; ``solve_batched``
    with ``TDistributionLoss()`` and by dogleg, each problem against its
    single solve and the reference's chi2;
  * the object API and differentiable solving (phases 43 to 45): sphere2500
    through ``Problem`` (2,500 ``SE3`` parameters, 4,948
    ``PoseToPoseResidual`` blocks, f32): the built graph
    ``build.pose_graph``'s tensor for tensor, route ``ell``, the chi2 and
    the ``ell_assemble`` / ``ell_pcg`` launches of ``solve_auto`` on it,
    under the sphere2500 gate; ``get_covariance_block`` of two poses (the
    lazy path) held in f64 to the selected inverse; ``solve_implicit`` at
    bench config 2's size (f64, 10,500 dof), its gradient held to central
    differences and to the JAX reference's (``chip_smoke_refs.npz``), the
    backward's sums the ``slot_reduce`` kernel through its autograd
    Function; a ``register_autodiff_factor`` clone of ``between_se3``
    (Jacobians within 1e-10 of the analytic kernel in f64; sphere2500
    solved through it on the general ELL assembly under the gate) and
    ``check_autodiff_factor`` refusing a row-coupled residual;
  * the VO frontends (phases 46 to 48, f32): dense RGB-D VO at VGA on
    ``bench/vo_overlap.py``'s 40 frames (4 levels, 24,576 pixels a level)
    frame by frame, prefetched and by ``track_batch`` at K = 16, each
    frame held to the JAX reference's trajectory (``chip_smoke_refs.npz``),
    the ATE by ``TrajectoryMetrics``; dense stereo VO at VGA with the
    on-device block matcher (the keyframe's disparity held to the
    reference's: NaN masks equal, values within 1e-4) and with the affine
    kernel through an exposure ramp (8 frames each; 16 when selected);
    ``examples/stereo_slam.py``'s pipeline (40 frames, 4,000 points) on
    the reference's RANSAC samples, the ATE of each stage within 1e-2 of
    the reference's. Each logs ms a frame (median, p90), fps, kernels and
    device ms a frame, synchronizing calls a frame, ``slot_reduce``
    launches, peak memory and the card's name and power limit;
    ``slot_reduce`` is checked at the single-pose and the batched sums, and
    at every plan and width that stereo SLAM launched it on;
  * the last modules (phases 49 to 51, f32): bench config 5 (Venice-mini)
    and config 6 at full size (phase 20's graph) through
    ``dist.solve_schur_cm`` on phase 23's one-rank NCCL mesh, under their
    gates and within 1e-4 of ``solve_schur_large`` and
    ``solve_schur_sharded``, 4 + CG budget ``psum`` an LM iteration
    (phase 27's two gloo ranks also run it on config 4's graph and through
    ``solve_auto``'s ``schur_cm`` route); config 6 through
    ``solve_schur_large(precond="cluster", cluster_size=64)`` and
    ``precond="stale"`` (``stale_refresh=3``) under its gate;
    sphere2500 through ``solve_ell(precond="two_level")`` and
    ``solve_bcsr`` at (``spmv``, ``precond_group``) = ("ell", 1),
    ("bcsr", 1), ("ell", 8) under its gate, no host read in a linear
    solve; ``slot_reduce`` at the rank's camera-sorted plans, the pair
    plans of S, the BCSR and coarse plans, ``ell_matvec`` at the
    ``EllPattern`` shape;
  * ``bal_rows`` at Venice's size (phase 53): BAL Venice's counts (1,778
    cameras, 993,923 points, 5,001,946 observations) as ``portbench``'s
    ``venice_ba`` generator makes them on the card, the kernel against its
    plain version in f32 and f64 and timed beside its bound and the chunked
    path it replaces, then that benchmark's solve through
    ``solve_schur_large`` as a main path, one launch a linearization;
  * the 9-dof ``bal_rows`` at BAL Final's size (phase 54): 13,682 cameras
    of 9 parameters, 4,456,117 points, 28,987,644 observations as
    ``portbench``'s ``bal_final13682`` generator makes them on the card,
    the kernel against its plain version (f32 whole, f64 on 2,000,000
    observations), timed beside its bound and the chunked path, then that
    benchmark's solve as a main path, one ``bal_rows9`` launch a
    linearization;
  * the native tokenizer (phase 52, host only): Venice-mini written by
    ``write_bal`` (``synthetic_bal(300, 60000, obs_per_pt=6)``) and bench
    config 2's graph by ``write_g2o``, each read back through the native
    path (``native.parse_doubles`` / ``native.scan_tagged``, built with
    ``g++`` at its first call) and through the plain Python tokenizers; the
    arrays must be equal, and both host load times are logged with the
    card's name and power limit.

Run from the repository root on a machine with a CUDA device and
``nvcc``; with no arguments it runs every phase:

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 37-42      # a selection, e.g. "32-36", "43-45", "46-48" or "49-51"
    python3 chip_smoke.py --parent DIR        # also put every slot_reduce launch to DIR's body rule

With ``--parent DIR`` (another checkout), each plan whose ``slot_reduce``
body DIR's rule gives otherwise is listed with the main path and line that
launched it, its launches, and both sides' device times on seeded rows of
its shape, at the end (``record_moved_bodies``, ``time_moved_bodies``).
Every run prints the launches of each main path by body
(``slot_reduce_bodies_by_path``).

A selection runs phases 1 and 2, the selected phases and the phases they
read from (4 to 22 for any of 23 to 27, 49 and 50; 24 for 49; 35 for 41;
39 for 40), and prints
the kernels line of what ran; the checks on that line (every kernel
launched on a main path, every column present) are made on the default
run.

Every phase raises on failure and the script then exits non-zero.  The
second-to-last line of standard output is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.  The script
imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
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
KERNELS = ("ell_matvec", "ell_pcg", "slot_reduce", "ell_assemble", "bal_rows")
# slot_reduce's bodies, each counted in LAUNCHES["slot_reduce.<body>"]
SLOT_BODIES = ("tiles", "subwarps", "block")
# the paths of phase 51 through solve_bcsr, by (spmv, precond_group)
BCSR_PATHS = {("ell", 1): "bcsr_sphere2500", ("bcsr", 1): "bcsr_bcsr_g1_sphere2500",
              ("ell", 8): "bcsr_ell_g8_sphere2500"}
# the paths of phases 37 to 42 (posterior covariance, the repaired
# solve_batched) that count as main paths in the kernels line
# keyframes of phase 32's stream in the default run (all 399 when the
# phase is selected)
VIO_PREFIX = 100
COVARIANCE_PATHS = ("cov_sphere2500_full", "cov_sphere2500_selinv", "cov_sphere2500_pcg", "cov_sphere2500_pairs",
                    "cov_m3500_solve", "cov_m3500_selinv", "cov_m3500_columns", "cov_config4_full",
                    "cov_config4_pcg", "cov_config4_sparse", "cov_venice_pcg", "cov_venice_sparse",
                    "cov_venice_sharded", "incremental_marginals_direct", "incremental_marginals_schur",
                    "incremental_marginals_dense", "batched_tdist_16", "batched_dogleg_16")
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
# bal_rows against its plain version, each column relative to its largest
# sum of the magnitudes of its terms (``cuda_ops.bal_rows_scale``).  f64:
# rounding only.  f32: the kernel contracts multiply-adds where the plain
# version rounds them apart, a residual of a few px beside a prediction of
# hundreds differs by a few roundings of the prediction, and a robust
# weight amplifies that (the limits of tests/test_torch_cuda.py).
BAL_TOL = {"float32": 2e-3, "float64": 1e-10}
# Operations of one bal_rows observation, counted from its source: the
# projection, residual and loss (about 60), the 2 x 9 Jacobian (about 90),
# 9 gradient rows of 3 and 45 Hessian and W rows of 5 (about 250).
BAL_ROWS_FLOP = 400
# ... of the 9-dof instantiation: the same 60, the 2 x 12 Jacobian (about
# 115), 12 gradient rows of 3 and 78 Hessian and W rows of 5 (about 425)
BAL_ROWS9_FLOP = 600

# The JAX reference's numbers for phases 28 to 31, recorded once on the CPU
# in f64 on the graphs those phases build, by
#     python scripts/torch_port_refs.py
# (about 4.5 minutes of CPU in two processes).  Phase 28: chi2 of the graph
# at each init; 'chordal' with the stages solved as the reference's
# _solve_stage declares (the port's policy: ELL PCG 1e-6 / 250 above 12,000
# dof), 'chordal_as_released' as its chordal_init solves them (solve_auto
# at every size: PCG 3e-6 / 120 there), printed beside.
REF_INIT_CHI2 = {
    ("sphere2500", "odometry"): 360129.2123577158, ("sphere2500", "spanning_tree"): 179115.7745209226,
    ("sphere2500", "chordal"): 7312.3637550394205, ("sphere2500", "chordal_as_released"): 7312.36369827971,
    ("m3500", "odometry"): 12686557.540441496, ("m3500", "spanning_tree"): 1527679.2163833163,
    ("m3500", "chordal"): 30557.85716787097, ("m3500", "chordal_as_released"): 43075.60487581152,
}
# Phase 29: solve_gnc on sphere2500 with 100 wrong loop closures (edges 4948
# to 5047): 30 outer iterations, the final robustified chi2, and the edges
# whose weight ends at or below 0.5: all 100 planted ones and these.
REF_GNC = dict(chi2=16470.22934995848, outer_iters=30, rejected=[
    57, 78, 117, 154, 169, 259, 271, 351, 490, 530, 537, 584, 735, 764, 856, 915, 1122, 1155, 1176, 1177, 1245,
    1283, 1332, 1343, 1365, 1379, 1450, 1472, 1515, 1558, 1644, 1668, 1673, 1867, 1878, 2053, 2075, 2085, 2155,
    2182, 2228, 2373, 2413, 2417, 2456, 2571, 2580, 2650, 2741, 2770, 2814, 2868, 2885, 2898, 2900, 2908, 2945,
    3072, 3104, 3109, 3133, 3138, 3153, 3296, 3308, 3315, 3317, 3338, 3399, 3408, 3584, 3626, 3642, 3736, 3815,
    3878, 3879, 3893, 3918, 3998, 4049, 4066, 4104, 4129, 4264, 4414, 4415, 4423, 4470, 4499, 4508, 4527, 4582,
    4643, 4652, 4704, 4725, 4763, 4894, 4921] + list(range(4948, 5048)))
# Phase 30: the switchable M3500 graph with 100 wrong loop closures, LM 60:
# 19 iterations, chi2, and the switches below 0.5: all 100 planted ones
# (switches 408 to 507) and these of the 408 true loops.
REF_SWITCH = dict(chi2=2740.7793584110714, iterations=19, below_half=[
    0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 13, 14, 15, 16, 18, 19, 21, 23, 25, 26, 28, 29, 31, 32, 33, 34, 35, 36, 37,
    40, 48, 49, 55, 57, 58, 59, 60, 61, 62, 64, 65, 67, 72, 73, 76, 77, 80, 81, 82, 87, 91, 92, 93, 110, 111, 112,
    113, 115, 116, 118, 125, 127, 128, 129, 130, 131, 132, 133, 134, 135, 136, 142, 143, 144, 145, 152, 153, 154]
    + list(range(408, 508)))
# Phase 31: vio_graph of 400 keyframes from EuRoC files, LM 60.
REF_VIO = dict(chi2_init=4743283409.355655, chi2=1040.727539485018, iterations=3)
# Phases 32 to 36, by the same script in f64 (its arrays — the newest-pose
# error, chi2, LM iterations and gyro-bias error of every keyframe of phase
# 32, the poses of phases 33 to 35 — are in chip_smoke_refs.npz beside this
# file).  Phase 32: the example's bounds, max newest-pose error 1e-2 over all
# keyframes and 5e-3 from the 6th, gyro-bias error 1.5e-3, were set for its
# 16 keyframes without an accelerometer bias; over phase 31's 400-keyframe
# trajectory (with one) the reference's own estimate meets the first and
# exceeds the other two: the second by these amounts, the third by 0.00169
# after the 399th keyframe (the npz array holds it after every keyframe).
REF_VIO_WINDOW = dict(max_err=0.008244954978694045, max_err_from_6th=0.008244954978694045)
# Phases 33 and 34: the reference's f32 run against its f64 run (largest
# entry of any pose matrix), the landmarks retired (in order) and live at the
# end of phase 34.
REF_FIXED_LAG = dict(sphere2500_f32_gap=0.03737706257836315, config8_f32_gap=12.141193741646033,
                     config8_retired=list(range(186)), config8_live=list(range(186, 250)))
# Phase 35: the chi2 and LM iterations of each of the 15 updates (14 of the
# stream, one after marginalize_oldest(keep_last=500)), the compiles count.
REF_INCREMENTAL = dict(chi2=[
    9.425265683064724, 11.077805738761775, 18.239277265498025, 25.92702982663771, 46.20531022311724,
    69.65465927876222, 87.3961684504769, 118.7090426469036, 134.2494074205122, 161.0185479017017,
    223.21571786759048, 266.1116934169573, 308.1755587080442, 622.1772888061158, 355.0036223068583],
    iterations=[5, 5, 5, 6, 4, 4, 5, 4, 5, 4, 5, 4, 4, 3, 1], compiles=9, n_final=501)
# Phase 36: solve_schur_sqrt (LM 50) of the f64 graph, and the f32 solves'
# relative chi2 gaps to it (square root, and solve_schur's dense mode).
REF_SQRT = dict(chi2=17546.457360488355, iterations=3, status=4, observations=28000,
                cost_history=[4314312.243715287, 21268.587815639024, 17619.581669896157, 17546.457360488355],
                gap_sqrt_f32=2.0385947836515653e-07, gap_dense_f32=9.035006901867403e-06)


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


def add_times(report, name, key, times, n_bytes, flop, label=None):
    """Accumulate one timed call into ``report[name]``: ``times`` maps
    "ms", "single_ms", "plain_ms", "library_ms" to this call's figures; the
    call's bound is computed from its bytes and operations.  ``key`` is
    "ms" for a sphere2500 call (the kernels line's columns) or
    "<config>_ms" for a dense-assembly shape; ``label`` names the shape in
    the log where it is not sphere2500's or the config's."""
    import math

    r = report[name]
    b_ms, by = bound_ms(n_bytes, flop)
    prefix = key[: -len("ms")]
    for k, v in {**times, "bound_ms": b_ms}.items():
        if v is not None:
            r[prefix + k] = r.get(prefix + k, 0.0) + v
    r.setdefault(prefix + "library_ms", None)
    r[prefix + "bound_by"] = by
    log(f"{name} {label or key[:-3] or 'sphere2500'}: {times}; bound {b_ms!r} ms by {by} "
        f"({n_bytes} B, {flop} flop); kernel / bound {times['ms'] / b_ms if b_ms else math.inf!r}")


def check_kernel(name, fn, plain, args, report, key, flop, library=None, calls=TIMING_CALLS):
    """``fn`` against ``plain`` on the same inputs in f32 and f64
    (``hold_kernel``), then the device time of each in f32, and of
    ``library`` (one PyTorch call on the same inputs, prepared outside the
    timing) where there is one; ``calls`` measurements of each (fewer for
    the shapes of millions of rows)."""
    import torch

    hold_kernel(name, fn, plain, args, report, library)
    times = dict(
        ms=median_ms(fn, args, calls=calls, inner=BACK_TO_BACK),
        single_ms=median_ms(fn, args, calls=calls),
        plain_ms=median_ms(plain, args, calls=calls),
        library_ms=median_ms(library, (), calls=calls, inner=BACK_TO_BACK) if library is not None else None,
    )
    tensors = [t for t in args if torch.is_tensor(t)]
    add_times(report, name, key, times, tensor_bytes(*tensors, fn(*args)), flop)


def hold_kernel(name, fn, plain, args, report, library=None, quiet=False):
    """``fn`` against ``plain`` on the same inputs in f32 and f64, within
    ``REL_TOL`` of the plain output's largest entry, and ``library`` where
    given (``slot_reduce`` also bit for bit against a second run); the f32
    error goes to the kernels line's ``max_abs_err``.
    Returns the largest relative error; logs each dtype's unless
    ``quiet``."""
    import torch

    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        a = [t.to(dtype) if torch.is_tensor(t) and t.is_floating_point() else t for t in args]
        out = fn(*a)
        ref = plain(*a)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        tname = str(dtype).split(".")[-1]
        if name == "slot_reduce":  # no atomics on values: the same bits on every run
            check(torch.equal(out, fn(*a)), f"{name} {tname}: two runs differ")
        worst = max(worst, err / scale if scale else err)
        if not quiet:
            log(f"{name} {tname} out{tuple(out.shape)}: max_abs_err {err!r} max|ref| {scale!r} rel {err / scale!r}")
        check(torch.isfinite(out).all().item(), f"{name} {tname}: non-finite output")
        check(err <= REL_TOL[tname] * scale, f"{name} {tname}: error {err} > {REL_TOL[tname]} * {scale}")
        r = report.setdefault(name, dict(max_abs_err=0.0))
        if dtype is torch.float32:
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if library is not None:
                lib_err = (library() - ref).abs().max().item()
                check(lib_err <= REL_TOL[tname] * scale, f"{name}: the library call disagrees by {lib_err}")
    return worst


def check_pcg(He, cols, g, rtol, max_iters, report, label="sphere2500", key="ms", library=None):
    """``ell_pcg`` against ``ell_pcg_plain`` on one system (block-Jacobi
    inverse from ``sym_block_inv``, as ``solve_ell`` makes it), in f32 and
    f64, and the device time of each in f32 under ``key`` of the kernels
    line: "ms" for the damped sphere2500 system of phase 3, whose rows must
    all be resident in shared memory.  ``library`` is one product of the
    same matrix with a vector (``sparse_bsr_tensor @ x``); its time times
    the kernel's iteration count stands as the library call.

    Tolerances.  f64: the same iteration count, x within 1e-9 of its
    largest entry (the kernel's dot products sum in another order, 1e-16 a
    step, over at most ``max_iters`` dependent steps).  f32: the count
    within one iteration where the run stops on its tolerance (the stop
    test compares two f32 norms computed in different orders), equal where
    it stops on the cap; x within 1e-4 of its largest entry (rounding of
    1e-7 a step grows over 120 dependent steps of an ill-conditioned
    system), and the kernel's true residual within 1% of the plain
    version's.  At the other keys (the undamped GN systems of the chordal
    rotation stages, far worse conditioned) x is held to ten times ``rtol``
    in f64 too: CG carries the other summation order to 1.5e-6 of x over
    217 iterations of sphere2500's stage in f64 while both runs meet the
    stop test (measured on an H100); counts and residuals as above."""
    import torch

    from pyslam_tpu_torch.solver import cuda_ops, linear
    from pyslam_tpu_torch.solver.bcsr import sym_block_inv

    x_tols = ((torch.float32, 1e-4), (torch.float64, 1e-9 if key == "ms" else 10 * rtol))
    for dtype, x_tol in x_tols:
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
        log(f"ell_pcg {label} {tname}: iterations {it} (plain {it_ref}, cap {max_iters}), resident rows {out.resident_rows} of "
            f"{He.shape[0]}, max_abs_err {err!r} max|ref| {scale!r} rel {err / scale!r}, "
            f"true residual {res!r} (plain {res_ref!r})")
        check(torch.isfinite(out.x).all().item(), f"ell_pcg {tname}: non-finite output")
        check(torch.equal(out.x, again.x) and it == int(again.iterations), f"ell_pcg {tname}: two runs differ")
        slack = 0 if dtype is torch.float64 or it_ref == max_iters else 1
        check(abs(it - it_ref) <= slack, f"ell_pcg {tname}: {it} iterations, plain {it_ref}")
        check(err <= x_tol * scale, f"ell_pcg {tname}: error {err} > {x_tol} * {scale}")
        check(res <= 1.01 * res_ref, f"ell_pcg {tname}: true residual {res} above the plain version's {res_ref}")
        if key == "ms":
            check(out.resident_rows == He.shape[0], "ell_pcg: sphere2500 should be resident in shared memory")
        nb, K, d, _ = He.shape
        log(f"ell_pcg {label} {tname}: launch plan {cuda_ops.ell_pcg_plan(nb, K, d, dtype, He.device)}")
        if dtype is torch.float32:
            r = report.setdefault("ell_pcg", dict(max_abs_err=0.0))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            # per iteration: the ELL product and the block-Jacobi product (2
            # flop a stored value), three dot products, three vector updates
            flop = it * (2 * nb * (K + 1) * d * d + 12 * nb * d)
            args = (*a, rtol, max_iters)
            ms = median_ms(lambda *b: cuda_ops.ell_pcg(*b), args)
            lib_ms = None if library is None else it * median_ms(library, (), inner=BACK_TO_BACK)
            times = dict(ms=ms, single_ms=ms, plain_ms=median_ms(cuda_ops.ell_pcg_plain, args, calls=5),
                         library_ms=lib_ms)
            add_times(report, "ell_pcg", key, times, tensor_bytes(*a, out.x), flop)
            log(f"ell_pcg {label} f32: {1e3 * ms / max(it, 1)!r} us per CG iteration")


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
    args = bcsr.ell_assemble_args(graph, dplan)
    check(args is not None, f"{label}: the graph is not one ell_assemble takes")
    batches = args[2]
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
                           dplan.a_rows, *out)
    n_rows = sum(bt.n_slots * bt.weight.shape[0] for bt in batches)
    # every entry's block in its row's diagonal slot, and the off-diagonal block of those that name a slot
    n_blocks = dplan.a_entries.shape[0] + int((dplan.a_entries[:, 1] > 0).sum())
    flop = (ASSEMBLE_FLOP["factor"] * dplan.a_idx.shape[0] + ASSEMBLE_FLOP["contribution"] * n_blocks
            + ASSEMBLE_FLOP["gradient_row"] * n_rows)
    add_times(report, "ell_assemble", "ms", times, n_bytes, flop)
    log(f"ell_assemble {label}: library_ms is the general route (ell_contributions + two slot_reduce + masks)")


def bal_cell(config, seed, dev):
    """The benchmark's BAL configuration ``config``
    (``portbench/configs/<config>.json``): its generator draws the problem
    from ``seed`` on ``dev`` and its entry builds the graph and the plan
    (``prepare_large_ba``).  (configuration, entry module, state), the plan
    in ``state["plan"]``."""
    import importlib

    with open(os.path.join(ROOT, "portbench", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    generator = importlib.import_module(f"portbench.generators.{cfg['generator']}")
    entry = importlib.import_module(f"portbench.entries.{cfg['entry']}")
    state = entry.build(generator.generate(cfg["sizes"], seed, dev), cfg, dev)
    entry.plan(state)
    return cfg, entry, state


def venice_bal_phase(report, drive):
    """Phase 53: ``bal_rows`` at Venice's size, on the ``venice_ba`` problem
    of ``portbench`` (1,778 cameras, 993,923 points, 5,001,946 monocular
    BAL observations, made on the card from seed 53) through its plan
    (n_chunks 128).  The kernel against ``bal_rows_plain`` over the plan's
    chunks, in f32 and f64 on the same inputs, rows and cost and the
    cost-only launch's cost within ``BAL_TOL`` of ``bal_rows_scale``, two
    launches bitwise equal; the device times of the kernel (20 back to back,
    and single), its plain version and the chunked path it replaces
    (``library_ms``) beside its bound by bytes (0.392 ms in f32);
    ``slot_reduce`` at the plan's sums by landmark, 3 and 9 wide on seeded
    rows (``check_slot_by_landmark``).  Then the benchmark's solve (LM 10,
    PCG 1e-4 / 12) as a main path, after a warm-up: one ``bal_rows`` launch
    a linearization, no plain version, the cost falling."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.observability import SPAN_CALLS
    from pyslam_tpu_torch.solver import cuda_ops, schur_large

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    _, venice_entry, state = bal_cell("venice_ba", 53, dev)
    plan = state["plan"]
    torch.cuda.synchronize()
    log(f"venice_ba: {plan.C} cameras, {plan.L} points, {plan.M} observations, made and planned in "
        f"{time.perf_counter() - t0!r} s")
    check(plan.bal, "venice_ba: the plan does not take bal_rows")
    chunk = plan.Mp // plan.n_chunks
    args32 = schur_large.bal_rows_args(plan, plan.poses, plan.lms)
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        tname = str(dtype).split(".")[-1]
        args = tuple(t.to(dtype) if t.is_floating_point() else t for t in args32)
        cost, rows = cuda_ops.bal_rows(*args, plan.loss)
        again = cuda_ops.bal_rows(*args, plan.loss)
        only, none = cuda_ops.bal_rows(*args, plan.loss, rows=False)
        ref = cuda_ops.bal_rows_plain(*args, plan.loss, chunk=chunk)
        rows_scale, cost_scale = cuda_ops.bal_rows_scale(*args, plan.loss, chunk=chunk)
        torch.cuda.synchronize()
        check(none is None and torch.equal(cost, again[0]) and torch.equal(rows, again[1]),
              f"bal_rows venice_ba {tname}: two runs differ")
        for name, out, r, scale in (("rows", rows, ref[1], rows_scale), ("cost", cost[:, None], ref[0][:, None],
                                    cost_scale), ("cost only", only[:, None], ref[0][:, None], cost_scale)):
            check(out.shape == r.shape and torch.isfinite(out).all().item(), f"bal_rows venice_ba {tname} {name}: "
                  "shape or non-finite")
            err = ((out - r).double().abs() / scale.clamp(min=1e-300)).max().item()
            log(f"bal_rows venice_ba {tname} {name}{tuple(out.shape)}: largest error {err!r} of its column's scale "
                f"(limit {BAL_TOL[tname]}), max_abs_err {(out - r).abs().max().item()!r}")
            check(err <= BAL_TOL[tname], f"bal_rows venice_ba {tname} {name}: error {err} > {BAL_TOL[tname]}")
            if dtype is torch.float32:
                worst = max(worst, (out - r).abs().max().item())
        del args, cost, rows, again, only, ref
    report["bal_rows"] = dict(max_abs_err=worst)

    def kernel(*a):
        return cuda_ops.bal_rows(*a, plan.loss)

    times = dict(
        ms=median_ms(kernel, args32, calls=20, inner=BACK_TO_BACK),
        single_ms=median_ms(kernel, args32, calls=20),
        plain_ms=median_ms(lambda *a: cuda_ops.bal_rows_plain(*a, plan.loss, chunk=chunk), args32, calls=3),
        # no one PyTorch call linearizes: the chunked path that the kernel replaces
        library_ms=median_ms(schur_large._obs_rows, (dataclasses.replace(plan, bal=False), plan.poses, plan.lms),
                             calls=3),
    )
    add_times(report, "bal_rows", "ms", times, tensor_bytes(*args32, *kernel(*args32)), BAL_ROWS_FLOP * plan.M,
              label="venice_ba")
    log("bal_rows venice_ba: library_ms is the chunked path (the factor kernel over 128 chunks, device time)")
    check_slot_by_landmark("venice_ba", plan, report, 53)

    def run():
        venice_entry.restore(state)
        return venice_entry.solve(state)

    run()  # warm-up
    rows_before = SPAN_CALLS.get("schur.linearize.rows", 0)
    t0 = time.perf_counter()
    out, launches, reads = drive("venice_ba_bal_rows", run, ("bal_rows", "slot_reduce"))
    wall = time.perf_counter() - t0
    linearizations = SPAN_CALLS.get("schur.linearize.rows", 0) - rows_before
    first = out["first_cost"]()
    log(f"solve venice_ba_bal_rows f32 (n_chunks 128, PCG 1e-4 / 12, LM 10): wall {1e3 * wall!r} ms, chi2 {first!r} "
        f"after the first step -> {out['chi2']!r}, linearizations {linearizations}, host reads {reads}, "
        f"launches {launches}")
    check(launches["bal_rows"] == linearizations > 1, f"venice_ba: {launches['bal_rows']} bal_rows launches for "
          f"{linearizations} linearizations")
    check(np.isfinite(out["chi2"]) and out["chi2"] <= first, f"venice_ba: chi2 {first} -> {out['chi2']}")
    check(torch.isfinite(out["poses"]).all().item() and torch.isfinite(out["landmarks"]).all().item(),
          "venice_ba: non-finite state")
    del state, plan, args32, out
    torch.cuda.empty_cache()


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


def parent_cuda_ops(parent):
    """The ``solver.cuda_ops`` module of the checkout at ``parent``: its
    package loaded under a name of its own, ``_parent_pyslam_tpu_torch``
    (the package imports itself only by relative imports), so that its
    ``slot_reduce`` runs with its own wrapper, body rule and kernels, the
    library built from its sources into its own ``build/``.  Its launches
    count in its own ``LAUNCHES``."""
    import importlib
    import importlib.util

    name = "_parent_pyslam_tpu_torch"
    if name not in sys.modules:
        pkg = os.path.join(os.path.abspath(parent), "pyslam_tpu_torch")
        spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                      submodule_search_locations=[pkg])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.solver.cuda_ops")


def slot_fns(longest):
    """``slot_reduce`` at a plan's longest segment, as the package's plans
    call it (the body that ``cuda_ops.slot_reduce_body`` gives the plan),
    and its plain version: the kernel and plain arguments of
    ``check_kernel`` and ``hold_kernel``."""
    import functools

    from pyslam_tpu_torch.solver import cuda_ops

    return functools.partial(cuda_ops.slot_reduce, longest=longest), cuda_ops.slot_reduce_plain


def check_slot_plan(key, contrib, seg, report):
    """``slot_reduce`` on one plan of the large Schur path (``Segments``):
    against the plain version in f32 and f64 and bit for bit against a
    second run (``hold_kernel``), then the device time of the kernel, of the
    plain version and of ``index_add_`` beside the call's bound, under the
    kernels line's key ``<key>_ms``; logs the body that the plan takes."""
    from pyslam_tpu_torch.solver import cuda_ops

    E, width = contrib.shape
    args = [contrib, seg.perm, seg.offsets, seg.n_slots]
    kernel, plain = slot_fns(seg.longest)
    log(f"slot_reduce {key}: {E} rows into {seg.n_slots} (longest {seg.longest}), "
        f"body {cuda_ops.slot_reduce_body(E, seg.n_slots, width, seg.longest)}")
    hold_kernel("slot_reduce", kernel, plain, args, report)
    lib = index_add_library(*args)
    n_bytes = tensor_bytes(contrib, seg.perm, seg.offsets) + seg.n_slots * width * 4
    add_times(report, "slot_reduce", f"{key}_ms",
              dict(ms=median_ms(kernel, args, calls=10, inner=5),
                   plain_ms=median_ms(cuda_ops.slot_reduce_plain, args, calls=5),
                   library_ms=median_ms(lib, (), calls=10)), n_bytes, contrib.numel())


def check_slot_by_landmark(name, plan, report, seed):
    """``check_slot_plan`` at a BAL plan's sums by landmark
    (``plan.by_lm``), on seeded rows 3 and 9 wide: the widths of the
    linearization's gradient and Hessian blocks and of the Schur products
    by landmark."""
    import torch

    gen = torch.Generator(device=plan.by_lm.perm.device).manual_seed(seed)
    for width in (3, 9):
        contrib = torch.randn((len(plan.by_lm.perm), width), generator=gen, device=plan.by_lm.perm.device)
        check_slot_plan(f"{name}_by_landmark_C{width}", contrib, plan.by_lm, report)
        del contrib
        torch.cuda.empty_cache()


def final_bal9_phase(report, drive):
    """Phase 54: the 9-dof ``bal_rows`` at BAL Final's size, on the
    ``bal_final13682`` problem of ``portbench`` (13,682 cameras of 9
    parameters, 4,456,117 points, 28,987,644 observations, made on the card
    from seed 54) through its plan (n_chunks 128).  The kernel against
    ``bal_rows_plain`` over the plan's chunks in f32 at full size and in
    f64 on the first 2,000,000 observations, rows and cost and the
    cost-only launch's cost within ``BAL_TOL`` of ``bal_rows_scale``, two
    launches bitwise equal; the device times of the kernel (20 back to back,
    and single), its plain version and the chunked path it replaces
    (``final_library_ms``) beside its bound by bytes (3.41 ms in f32);
    ``slot_reduce`` at the plan's sums by landmark, 3 and 9 wide on seeded
    rows (``check_slot_by_landmark``).  Then the benchmark's solve (LM 5,
    PCG 1e-4 / 12) as a main path, after a warm-up: one ``bal_rows9`` launch
    a linearization, no 6-dof launch, no plain version, the cost falling;
    its peak memory."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.observability import SPAN_CALLS
    from pyslam_tpu_torch.solver import cuda_ops, schur_large

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    cfg, final_entry, state = bal_cell("bal_final13682", 54, dev)
    plan = state["plan"]
    torch.cuda.synchronize()
    log(f"bal_final13682: {plan.C} cameras of {plan.dp} dof, {plan.L} points, {plan.M} observations, made and "
        f"planned in {time.perf_counter() - t0!r} s")
    check(plan.bal and plan.dp == 9, "bal_final13682: the plan does not take the 9-dof bal_rows")
    chunk = plan.Mp // plan.n_chunks
    args32 = schur_large.bal_rows_args(plan, plan.poses, plan.lms)
    worst = 0.0
    for dtype, M in ((torch.float32, plan.M), (torch.float64, 2_000_000)):
        tname = str(dtype).split(".")[-1]
        args = tuple(None if t is None else t.to(dtype) if t.is_floating_point() else t for t in args32)
        args = args[:2] + tuple(None if t is None else t[:M] for t in args[2:8]) + (args[8], args[9][:M])
        cost, rows = cuda_ops.bal_rows(*args, plan.loss)
        again = cuda_ops.bal_rows(*args, plan.loss)
        only, none = cuda_ops.bal_rows(*args, plan.loss, rows=False)
        check(none is None and torch.equal(cost, again[0]) and torch.equal(rows, again[1]),
              f"bal_rows9 bal_final13682 {tname}: two runs differ")
        del again
        ref = cuda_ops.bal_rows_plain(*args, plan.loss, chunk=chunk)
        rows_scale, cost_scale = cuda_ops.bal_rows_scale(*args, plan.loss, chunk=chunk)
        torch.cuda.synchronize()
        for name, out, r, scale in (("rows", rows, ref[1], rows_scale), ("cost", cost[:, None], ref[0][:, None],
                                    cost_scale), ("cost only", only[:, None], ref[0][:, None], cost_scale)):
            check(out.shape == r.shape and torch.isfinite(out).all().item(),
                  f"bal_rows9 bal_final13682 {tname} {name}: shape or non-finite")
            err = ((out - r).abs() / scale.clamp(min=1e-300).to(out.dtype)).max().item()
            log(f"bal_rows9 bal_final13682 {tname} {name}{tuple(out.shape)}: largest error {err!r} of its column's "
                f"scale (limit {BAL_TOL[tname]}), max_abs_err {(out - r).abs().max().item()!r}")
            check(err <= BAL_TOL[tname], f"bal_rows9 bal_final13682 {tname} {name}: error {err} > {BAL_TOL[tname]}")
            if dtype is torch.float32:
                worst = max(worst, (out - r).abs().max().item())
        del args, cost, rows, only, ref
        torch.cuda.empty_cache()
    report.setdefault("bal_rows", {})["final_max_abs_err"] = worst

    def kernel(*a):
        return cuda_ops.bal_rows(*a, plan.loss)

    times = dict(
        ms=median_ms(kernel, args32, calls=10, inner=BACK_TO_BACK),
        single_ms=median_ms(kernel, args32, calls=10),
        plain_ms=median_ms(lambda *a: cuda_ops.bal_rows_plain(*a, plan.loss, chunk=chunk), args32, calls=1),
        # no one PyTorch call linearizes: the chunked path that the kernel replaces
        library_ms=median_ms(schur_large._obs_rows, (dataclasses.replace(plan, bal=False), plan.poses, plan.lms),
                             calls=1),
    )
    n_bytes = tensor_bytes(*(t for t in args32 if t is not None), *kernel(*args32))
    add_times(report, "bal_rows", "final_ms", times, n_bytes, BAL_ROWS9_FLOP * plan.M, label="bal_final13682 (9 dof)")
    log("bal_rows9 bal_final13682: library_ms is the chunked path (the factor kernel over 128 chunks, device time)")
    torch.cuda.empty_cache()
    check_slot_by_landmark("final", plan, report, 54)

    def run():
        final_entry.restore(state)
        return final_entry.solve(state)

    run()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    rows_before = SPAN_CALLS.get("schur.linearize.rows", 0)
    t0 = time.perf_counter()
    out, launches, reads = drive("bal_final13682_bal_rows9", run, ("slot_reduce", "bal_rows9"))
    wall = time.perf_counter() - t0
    linearizations = SPAN_CALLS.get("schur.linearize.rows", 0) - rows_before
    first = out["first_cost"]()
    log(f"solve bal_final13682 f32 (n_chunks 128, PCG 1e-4 / 12, LM {cfg['options']['max_iters']}): wall {1e3 * wall!r} ms, chi2 {first!r} "
        f"after the first step -> {out['chi2']!r}, linearizations {linearizations}, host reads {reads}, "
        f"launches {launches}, peak {torch.cuda.max_memory_allocated()!r} B")
    check(launches["bal_rows9"] == linearizations > 1 and launches["bal_rows"] == 0,
          f"bal_final13682: {launches['bal_rows9']} bal_rows9 and {launches['bal_rows']} bal_rows launches for "
          f"{linearizations} linearizations")
    check(np.isfinite(out["chi2"]) and out["chi2"] <= first, f"bal_final13682: chi2 {first} -> {out['chi2']}")
    check(torch.isfinite(out["poses"]).all().item() and torch.isfinite(out["landmarks"]).all().item(),
          "bal_final13682: non-finite state")
    del state, plan, args32, out
    torch.cuda.empty_cache()

def parse_phases(spec):
    """The phase numbers of a ``--phases`` argument such as "37-42" or
    "1-3,32,37-42"; None (every phase) for None."""
    if spec is None:
        return None
    out = set()
    for part in spec.split(","):
        lo, _, hi = part.strip().partition("-")
        out.update(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description="the port's smoke test on one CUDA device")
    ap.add_argument("--phases", default=None,
                    help='phases to run, e.g. "37-42" or "28-31,37": the phases a selected one reads from run too '
                         "(4 to 22 for any of 23 to 27 and 49 to 50, 24 for 49, 35 for 41); phases 1 and 2 always "
                         "run; default every phase")
    ap.add_argument("--parent", default=None,
                    help="another checkout: every slot_reduce launch is also put to its body rule, and each plan "
                         "to which it gives another body is timed on both sides at the end (its library built "
                         "from its sources)")
    cli = ap.parse_args(argv)
    phases = parse_phases(cli.phases)
    if phases is not None and 49 in phases:
        phases.add(24)  # phase 49 is held to phase 24's chi2

    def want(*numbers):
        return phases is None or any(n in phases for n in numbers)

    # ---- phase 1: device -------------------------------------------------
    t_start = time.perf_counter()
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no GPU to run on")
    import pyslam_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from pyslam_tpu_torch import _ext
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import bal, synth
    from pyslam_tpu_torch.losses import CauchyLoss
    from pyslam_tpu_torch.solver import (
        assemble,
        cuda_ops,
        linear,
        route_auto,
        schur,
        schur_large,
        schur_sparse,
        solve_auto,
        solve_batched,
        sparse_chol,
    )
    from pyslam_tpu_torch.solver.assemble import linearize_batch
    from pyslam_tpu_torch.solver.bcsr import (
        assemble_ell,
        build_ell_direct,
        ell_contributions,
        ell_device_plan,
        solve_ell,
    )
    from pyslam_tpu_torch.solver.lm import STATUS_NAMES, Options, _dense_solve, solve
    from pyslam_tpu_torch.testing import se3_pair_graph, se3_stress_graph

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
    if want(3):
        # library yardstick of ell_matvec: one BSR product (6x6 blocks), the
        # matrix built once outside the timing
        bsr = bsr_matrix(He, plan)
        check_kernel("ell_matvec", cuda_ops.ell_matvec, cuda_ops.ell_matvec_plain, [He, dplan.cols, x], report, "ms",
                     flop=2 * nb * K * d * d, library=lambda: (bsr @ x[:, None])[:, 0])
        for contrib, perm, offsets, n_slots, longest in (
                (h_contrib, dplan.h_perm, dplan.h_offsets, nb * K, dplan.h_longest),
                (g_contrib, dplan.g_perm, dplan.g_offsets, nb, dplan.g_longest)):
            check_kernel("slot_reduce", *slot_fns(longest),
                         [contrib, perm, offsets, n_slots], report, "ms", flop=contrib.numel(),
                         library=index_add_library(contrib, perm, offsets, n_slots))
        # ell_pcg on the first linear system of the solve: He damped as
        # solve_ell damps it at lambda_init, its block-Jacobi inverse, the
        # gradient
        He_d = He.clone()
        diag = torch.clamp(torch.diagonal(He[:, 0], dim1=-2, dim2=-1), min=1e-12)
        He_d[:, 0] += Options().lambda_init * torch.diag_embed(diag)
        check_pcg(He_d, dplan.cols, g_vec, 3e-6, 120, report)

        # ---- phase 3a: ell_assemble vs its plain version -------------------
        # sphere2500 (timed), then the stress graph (special angles, priors,
        # padding, a frozen interior pose) under L2 and Cauchy, and the graph
        # whose slots sum several factors of one pose pair, f32 and f64
        check_assemble("sphere2500", graph, report)
        check_assemble("sphere2500", build.pose_graph(data, dtype=torch.float64))
        for dtype in (torch.float32, torch.float64):
            check_assemble("stress graph L2", se3_stress_graph(dtype=dtype))
            check_assemble("stress graph Cauchy", se3_stress_graph(loss=CauchyLoss(2.0), dtype=dtype))
            check_assemble("shared pairs Cauchy", se3_pair_graph(loss=CauchyLoss(2.0), dtype=dtype))
            check_assemble("sphere2500 Cauchy", build.pose_graph(data, loss=CauchyLoss(2.0), dtype=dtype))

    # ---- phase 3b: slot_reduce at the dense-assembly shapes of configs 1, 2, 7
    # The graphs that phases 6-8 solve.  Config 2's goes through the g2o
    # writer and reader, as in bench/run.py.
    loop = synth.se2_loop(n_poses=100, n_loops=12, seed=0)
    g_1 = build.pose_graph(loop, loss=CauchyLoss(2.0))
    m3500 = m3500_data()
    g_m = build.pose_graph(m3500, dtype=torch.float32)
    m_plan = assemble.dense_plan(g_m)
    loop7 = synth.sim3_loop(n_poses=400, n_loops=10, scale_drift=0.005, odo_scale_std=0.005, seed=0)
    g_7 = build.sim3_pose_graph(loop7)
    if want(3):
        for cfg, g_d in (("config1", g_1), ("config2", g_m), ("config7", g_7)):
            dense_slot_reduce(cfg, g_d, report, f"{cfg}_ms")
    torch.cuda.synchronize()

    # ---- phase 3c: slot_reduce at the Schur shapes of config 4 -------------
    # The graph that phase 10 solves.  The sums of one assembly into the
    # camera blocks (M x 36 into 49) and the landmark blocks (M x 9 into
    # 7,000), and the two of one product with the implicit S (W^T x by
    # landmark, W t by camera).
    ba = synth.ba_synthetic(n_cams=49, n_pts=7000, seed=0)
    g_4 = build.ba_graph(ba)
    check(g_4.blocks["poses"].values.device.type == "cuda" and g_4.blocks["poses"].values.dtype == torch.float32,
          "ba_graph did not build in f32 on the card by default")
    if want(3):
        s_plan = schur.schur_plan(g_4)
        parts_4, grad_4, chi2_4 = schur.ba_assemble(g_4, plan=s_plan)
        M = parts_4["W"].shape[0]
        _, (J_cam, J_pt), w_4, _ = linearize_batch(g_4.batches[0], g_4.blocks)
        # the camera part of the first LM step (the graph's tangent has 'landmarks' before 'poses')
        step_4 = schur.schur_solve_dense(parts_4, grad_4, torch.tensor(1e-4, device=dev), Options(method="lm"))
        x_cam = step_4[s_plan.L * s_plan.dl:].reshape(s_plan.C, s_plan.dp).contiguous()
        check(not s_plan.pose_first and torch.isfinite(x_cam).all().item(), "config4: the first LM step")
        Wt_x = schur._tmv(parts_4["W"], x_cam[s_plan.cam_idx])
        W_t = schur._mv(parts_4["W"], s_plan.by_lm.sum(Wt_x)[s_plan.pt_idx])
        log(f"config4: cameras {s_plan.C}, landmarks {s_plan.L}, observations {M}, start chi2 {chi2_4.item()!r}")
        for label, contrib, seg in (("Hpp", schur._jtwj(J_cam, w_4, J_cam), s_plan.to_pose),
                                    ("Hll", schur._jtwj(J_pt, w_4, J_pt), s_plan.to_lm),
                                    ("S product, by landmark", Wt_x, s_plan.by_lm),
                                    ("S product, by camera", W_t, s_plan.by_cam)):
            contrib = contrib.reshape(M, -1).contiguous()
            log(f"config4 {label}: contributions {tuple(contrib.shape)} into {seg.n_slots} destinations")
            check_kernel("slot_reduce", *slot_fns(seg.longest),
                         [contrib, seg.perm, seg.offsets, seg.n_slots], report, "config4_ms", flop=contrib.numel(),
                         library=index_add_library(contrib, seg.perm, seg.offsets, seg.n_slots))
        again_4, grad_again, chi2_again = schur.ba_assemble(g_4, plan=s_plan)
        check(all(torch.equal(again_4[k], parts_4[k]) for k in ("Hpp", "Hll", "W", "g_p", "g_l"))
              and torch.equal(grad_again, grad_4) and torch.equal(chi2_again, chi2_4),
              "config4: two runs of ba_assemble differ in their bits")
        del J_cam, J_pt, w_4, Wt_x, W_t, again_4
        torch.cuda.synchronize()

    launches_by_path, bodies_by_path, driven = {}, {}, [None]
    moved = {}  # with --parent: the plans whose body the parent's rule gives otherwise (record_moved_bodies)
    against_parent = contextlib.ExitStack()
    if cli.parent:
        against_parent.enter_context(record_moved_bodies(parent_cuda_ops(cli.parent), moved, lambda: driven[0]))

    def drive(path, run, kernels):
        """Counts to 0, the path, counts read: each kernel of ``kernels``
        was launched and no plain version ran; ``slot_reduce``'s launches
        by body add up to its launches."""
        torch.cuda.synchronize()
        cuda_ops.reset_launches()
        linear.reset_host_reads()
        driven[0] = path
        try:
            out = run()
        finally:
            driven[0] = None
        torch.cuda.synchronize()
        launches, reads = dict(cuda_ops.LAUNCHES), dict(linear.HOST_READS)
        for k in KERNELS:
            if k in kernels:
                check(launches[k] > 0, f"{path}: kernel {k} was not launched")
            check(launches[f"{k}_plain"] == 0, f"{path}: plain {k} ran")
        launches_by_path[path] = {k: launches[k] for k in kernels}
        bodies = {b: launches[f"slot_reduce.{b}"] for b in SLOT_BODIES}
        check(sum(bodies.values()) == launches["slot_reduce"],
              f"{path}: slot_reduce launches by body {bodies}, {launches['slot_reduce']} in all")
        if launches["slot_reduce"]:
            bodies_by_path[path] = bodies
        return out, launches, reads

    def gate(name, chi2, factor, ref):
        log(f"{name}: chi2 {chi2!r} gate {factor * ref!r} ({factor} x {ref!r})")
        check(np.isfinite(chi2) and chi2 <= factor * ref, f"{name}: chi2 {chi2} above {factor} x {ref}")

    def check_poses(name, solved, shape):
        poses = solved.blocks["poses"].values
        check(tuple(poses.shape) == shape, f"{name}: poses shape {tuple(poses.shape)}")
        check(torch.isfinite(poses).all().item(), f"{name}: non-finite poses")

    if want(53):
        venice_bal_phase(report, drive)
    if want(54):
        final_bal9_phase(report, drive)

    run_main = want(*range(4, 28), 49, 50)  # phases 23 to 27, 49 and 50 read what 4 to 22 made
    if run_main:
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
        sphere_solved = solved  # phase 37's estimate

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

        # ---- phase 10: bench config 4, bundle adjustment through solve_schur ---
        opts4 = Options(method="lm", max_iters=25)
        n_obs = g_4.batches[0].n
        s_plan = schur.schur_plan(g_4)  # phase 3c's, also when a selection skips phase 3
        chi2_modes = {}
        for mode, kw in (("pcg", dict(pcg_rtol=1e-4, pcg_max_iters=30)), ("dense", {})):
            path = f"config4_ba_schur_{mode}"

            def run_ba():
                return schur.solve_schur(g_4, opts4, mode=mode, **kw)

            _, warm_info = run_ba()  # warm-up
            warm_info.chi2.item()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (solved_4, info_4), launches, reads = drive(path, run_ba, ("slot_reduce",))
            chi2_modes[mode] = info_4.chi2.item()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            log(
                f"solve {path} f32 ({s_plan.C} cameras, {s_plan.L} points, {n_obs} observations): wall {1e3 * wall!r} ms, "
                f"LM iterations {info_4.iterations}, status {STATUS_NAMES[info_4.status]!r}, chi2 "
                f"{info_4.cost_history[0].item()!r} -> {chi2_modes[mode]!r}, accepted "
                f"{info_4.accepted[: info_4.iterations].tolist()}, host reads {reads}, launches {launches}, "
                f"peak memory {peak} B"
            )
            check(reads["lm"] == info_4.iterations, f"{path}: host reads {reads} for {info_4.iterations} LM iterations")
            if mode == "dense":
                # four sums an assembly (iterations + 1 of them); the reduced
                # gradient, the (camera, landmark) pairs and the back
                # substitution a linear solve
                expected = 4 * (info_4.iterations + 1) + 3 * info_4.iterations
                check(launches["slot_reduce"] == expected and reads["pcg"] == 0,
                      f"{path}: {launches['slot_reduce']} slot_reduce launches, expected {expected}; reads {reads}")
            else:
                check(0 < reads["pcg"] <= info_4.iterations * 30,
                      f"{path}: the CG loop read its stop test {reads['pcg']} times")
            gate(f"config4 ba_ladybug_49_7000 mode={mode}", chi2_modes[mode], STANDIN_GATE,
                 standin["ba_ladybug_49_7000"]["chi2"])
            check_poses(path, solved_4, (s_plan.C, 4, 4))
            pts = solved_4.blocks["landmarks"].values
            check(tuple(pts.shape) == (s_plan.L, 3) and torch.isfinite(pts).all().item(), f"{path}: landmarks")
            check(torch.equal(solved_4.blocks["poses"].values[0], g_4.blocks["poses"].values[0]),
                  f"{path}: the gauge camera moved")

        # ---- phase 11: small Schur paths, for coverage (no reference gate) ------
        small_graphs = [("bal_cam9 (optimized intrinsics)",
                         build.bal_graph(bal.perturbed(bal.synthetic_bal(n_cams=12, n_pts=300, seed=1)),
                                         optimize_intrinsics=True, dtype=torch.float64))]
        for obs_type in ("bearing_range", "xy"):
            lm2d = synth.landmark_slam_2d(n_poses=40, n_landmarks=25, obs_type=obs_type, seed=3)
            small_graphs.append((f"landmark_slam_2d {obs_type}", build.landmark_slam_2d(lm2d)))
        for label, g_s in small_graphs:
            check(g_s.blocks["poses"].values.device.type == "cuda", f"{label}: not built on the card by default")
            (solved_s, info_s), launches, reads = drive(
                "schur_small_" + label.replace(" ", "_"), lambda: schur.solve_schur(g_s, Options(method="lm", max_iters=25)),
                ("slot_reduce",))
            c0, c1 = info_s.cost_history[0].item(), info_s.chi2.item()
            kinds = {n: (b.kind, b.dof) for n, b in g_s.blocks.items()}
            log(f"solve_schur dense {label} {g_s.blocks['poses'].values.dtype}: blocks {kinds}, batches "
                f"{[fb.kind for fb in g_s.batches]}, LM iterations {info_s.iterations}, status "
                f"{STATUS_NAMES[info_s.status]!r}, chi2 {c0!r} -> {c1!r}, launches {launches}, host reads {reads}")
            check(np.isfinite(c1) and c1 < 0.1 * c0, f"{label}: chi2 {c0} -> {c1}, not below a tenth of its start")
            check(all(torch.isfinite(b.values).all().item() for b in solved_s.blocks.values()), f"{label}: non-finite")

        # ---- phase 12: f64 cross-check of solve_schur, CPU path vs card path ----
        ba_small = synth.ba_synthetic(n_cams=8, n_pts=60, seed=3)
        for mode in ("dense", "pcg"):
            res = {where: schur.solve_schur(build.ba_graph(ba_small, dtype=torch.float64, device=where),
                                            Options(method="lm", max_iters=30), mode=mode)[::-1]
                   for where in ("cpu", "cuda")}
            cross_check(f"ba_synthetic(8, 60) solve_schur {mode}", res, rel=1e-9)

        # ---- phase 13: bench config 8, landmark SLAM through solve_auto ---------
        lm8 = synth.landmark_slam_2d(n_poses=800, n_landmarks=250, max_range=10.0, obs_type="bearing_range",
                                     odo_rot_std=0.005, seed=0)
        g_8 = build.landmark_slam_2d(lm8)
        pb8, lb8 = g_8.blocks["poses"], g_8.blocks["landmarks"]
        hpl_bytes = pb8.n * pb8.dof * lb8.n * lb8.dof * pb8.values.element_size()
        route_8 = route_auto(g_8)
        log(f"config8: {pb8.n} poses ({pb8.n * pb8.dof} dof), {lb8.n} landmarks, batches "
            f"{[(fb.kind, fb.n) for fb in g_8.batches]}, Hpl {hpl_bytes} B, route {route_8!r}")
        check(route_8 == "schur_dense", f"config8: route {route_8!r}, expected 'schur_dense'")
        opts8 = Options(method="lm", max_iters=30)
        solve_auto(g_8, opts8)[1].chi2.item()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (solved_8, info_8), launches, reads = drive("config8_landmark_slam_800", lambda: solve_auto(g_8, opts8),
                                                    ("slot_reduce",))
        chi2_8 = info_8.chi2.item()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        log(f"solve config8 f32 (solve_auto -> schur_dense): wall {1e3 * wall!r} ms, LM iterations {info_8.iterations}, "
            f"status {STATUS_NAMES[info_8.status]!r}, chi2 {info_8.cost_history[0].item()!r} -> {chi2_8!r}, accepted "
            f"{info_8.accepted[: info_8.iterations].tolist()}, host reads {reads}, launches {launches}, peak memory {peak} B")
        check(reads == {"pcg": 0, "lm": info_8.iterations}, f"config8: host reads {reads}")
        gate("config8 landmark_slam_800_v2", chi2_8, STANDIN_GATE, standin["landmark_slam_800_v2"]["chi2"])
        check_poses("config8", solved_8, (800, 3, 3))
        check(torch.isfinite(solved_8.blocks["landmarks"].values).all().item(), "config8: non-finite landmarks")

        # ---- phase 14: solve_sparse_chol at config 2's size ---------------------
        # The graph of phase 7 (se2_manhattan(3500) through g2o, D = 10,500) and
        # config 2's options, against the dense path's chi2 of that phase.
        t0 = time.perf_counter()
        chol_m = sparse_chol.build_chol_plan(g_m)
        plan_ms = 1e3 * (time.perf_counter() - t0)
        waves = [(N, kpad, bpad) for kpad, bpad, N, *_ in chol_m.waves]
        widest = max(waves, key=lambda w: w[0] * (w[1] + w[2]) ** 2)
        log(f"config2 sparse_chol plan: host {plan_ms!r} ms, {len(waves)} waves (N, kpad, bpad) {waves}; widest "
            f"gather N={widest[0]} kpad={widest[1]} bpad={widest[2]}; pool_total {chol_m.pool_total} blocks")

        def run_chol():
            return sparse_chol.solve_sparse_chol(g_m, opts2, plan=chol_m)

        run_chol()[1].chi2.item()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (solved_c, info_c), launches, reads = drive("config2_sparse_chol", run_chol, ("slot_reduce",))
        chi2_c = info_c.chi2.item()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        log(f"solve config2 sparse_chol f32: wall {1e3 * wall!r} ms, GN iterations {info_c.iterations}, status "
            f"{STATUS_NAMES[info_c.status]!r}, chi2 {chi2_c!r} (dense path {chi2_m!r}, rel "
            f"{abs(chi2_c - chi2_m) / chi2_m!r}), host reads {reads}, launches {launches}, peak memory {peak} B "
            f"(the dense path's H alone: {D * D * 4} B)")
        check(reads == {"pcg": 0, "lm": info_c.iterations}, f"config2 sparse_chol: host reads {reads}")
        gate("config2 se2_manhattan_3500 (sparse_chol)", chi2_c, STANDIN_GATE, standin["se2_manhattan_3500"]["chi2"])
        check(abs(chi2_c - chi2_m) <= 1e-4 * chi2_m, f"config2 sparse_chol: chi2 {chi2_c} vs dense {chi2_m}")
        check_poses("config2_sparse_chol", solved_c, (3500, 3, 3))
        solved_again, info_again = run_chol()
        check(torch.equal(info_again.chi2, info_c.chi2)
              and torch.equal(solved_again.blocks["poses"].values, solved_c.blocks["poses"].values),
              "config2 sparse_chol: two runs differ in their bits")
        # slot_reduce at every wave's forward-solve plan
        rng = np.random.default_rng(SEED)
        for i, w in enumerate(sparse_chol._device_waves(chol_m, dev)):
            if not w.fwd_dest.numel():
                continue
            contrib = torch.from_numpy(rng.normal(size=(w.fwd_perm.shape[0], chol_m.d))).to(dev, torch.float32)
            log(f"config2 sparse_chol wave {i} (N={w.N}, bpad={w.bpad}): contributions {tuple(contrib.shape)} into "
                f"{w.fwd_slots} destinations")
            check_kernel("slot_reduce", *slot_fns(w.fwd_longest),
                         [contrib, w.fwd_perm, w.fwd_offsets, w.fwd_slots], report, "config2_sparse_chol_ms",
                         flop=contrib.numel(), library=index_add_library(contrib, w.fwd_perm, w.fwd_offsets, w.fwd_slots))

        # ---- phase 15: the sparse_chol route beyond the dense ceiling ----------
        g_5k = build.pose_graph(synth.se2_manhattan(n_poses=5000, seed=1), dtype=torch.float32)
        route_5k = route_auto(g_5k)
        check(route_5k == "sparse_chol", f"se2_manhattan(5000): route {route_5k!r}, expected 'sparse_chol'")
        t0 = time.perf_counter()
        chol_5k = sparse_chol.build_chol_plan(g_5k)
        log(f"se2_manhattan(5000) sparse_chol plan: host {1e3 * (time.perf_counter() - t0)!r} ms, "
            f"{len(chol_5k.waves)} waves, pool_total {chol_5k.pool_total} blocks")
        t0 = time.perf_counter()
        (solved_5k, info_5k), launches, reads = drive("sparse_chol_5000", lambda: solve_auto(g_5k, opts2),
                                                      ("slot_reduce",))
        chi2_5k = info_5k.chi2.item()
        wall = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, info_5d = solve(g_5k, opts2)
        chi2_5d = info_5d.chi2.item()
        wall_dense = time.perf_counter() - t0
        peak_dense = torch.cuda.max_memory_allocated()
        log(f"solve se2_manhattan(5000) f32 (15,000 dof): solve_auto -> sparse_chol wall {1e3 * wall!r} ms (nested "
            f"dissection included), GN iterations {info_5k.iterations}, chi2 {chi2_5k!r}, host reads {reads}, launches "
            f"{launches}; dense solve wall {1e3 * wall_dense!r} ms, GN iterations {info_5d.iterations}, chi2 "
            f"{chi2_5d!r}, peak memory {peak_dense} B; rel {abs(chi2_5k - chi2_5d) / chi2_5d!r}")
        check(reads == {"pcg": 0, "lm": info_5k.iterations}, f"sparse_chol_5000: host reads {reads}")
        check(np.isfinite(chi2_5k) and abs(chi2_5k - chi2_5d) <= 1e-4 * chi2_5d,
              f"sparse_chol_5000: chi2 {chi2_5k} vs dense {chi2_5d}")
        check_poses("sparse_chol_5000", solved_5k, (5000, 3, 3))

        # ---- phase 16: schur_sparse through solve_auto -------------------------
        lm2k = synth.landmark_slam_2d(n_poses=2000, n_landmarks=300, max_range=10.0, odo_rot_std=0.005, seed=0)
        g_2k = build.landmark_slam_2d(lm2k)
        route_2k = route_auto(g_2k)
        check(route_2k == "schur_sparse", f"landmark_slam_2d(2000, 300): route {route_2k!r}, expected 'schur_sparse'")
        t0 = time.perf_counter()
        ss_plan = schur_sparse.build_schur_sparse_plan(g_2k)
        plan_ms = 1e3 * (time.perf_counter() - t0)
        ss_waves = [(N, kpad, bpad) for kpad, bpad, N, *_ in ss_plan.chol.waves]
        log(f"landmark_slam_2d(2000, 300): {g_2k.batches[0].n} observations, pairs {ss_plan.n_pairs}, S edges "
            f"{ss_plan.n_edges}, plan host {plan_ms!r} ms, {len(ss_waves)} waves {ss_waves}")
        opts16 = Options(method="lm", max_iters=30)
        solve_auto(g_2k, opts16)[1].chi2.item()  # warm-up (and the plan, cached by content)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (solved_2k, info_2k), launches, reads = drive("schur_sparse_2000", lambda: solve_auto(g_2k, opts16),
                                                      ("slot_reduce",))
        chi2_2k = info_2k.chi2.item()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        solved_2d, info_2d = schur.solve_schur(g_2k, opts16, mode="dense")
        chi2_2d = info_2d.chi2.item()
        wall_dense = time.perf_counter() - t0
        # both f32 solutions' costs evaluated in f64
        g_2k64 = build.landmark_slam_2d(lm2k, dtype=torch.float64)
        in_f64 = [g_2k64.with_values({n: dataclasses.replace(b, values=s_.blocks[n].values.double())
                                      for n, b in g_2k64.blocks.items()}).chi2().item() for s_ in (solved_2k, solved_2d)]
        log(f"solve landmark_slam_2d(2000, 300) f32: solve_auto -> schur_sparse wall {1e3 * wall!r} ms, LM iterations "
            f"{info_2k.iterations}, chi2 {info_2k.cost_history[0].item()!r} -> {chi2_2k!r}, accepted "
            f"{info_2k.accepted[: info_2k.iterations].tolist()}, host reads {reads}, launches {launches}, peak memory "
            f"{peak} B; solve_schur dense (S 6000^2) wall {1e3 * wall_dense!r} ms, LM iterations {info_2d.iterations}, "
            f"chi2 {chi2_2d!r}, accepted {info_2d.accepted[: info_2d.iterations].tolist()}; rel "
            f"{abs(chi2_2k - chi2_2d) / chi2_2d!r}; the two solutions' chi2 in f64 {in_f64}")
        check(reads == {"pcg": 0, "lm": info_2k.iterations}, f"schur_sparse_2000: host reads {reads}")
        check(np.isfinite(chi2_2k) and chi2_2k < 0.01 * info_2k.cost_history[0].item(),
              f"schur_sparse_2000: chi2 {chi2_2k} not below a hundredth of its start")
        check_poses("schur_sparse_2000", solved_2k, (2000, 3, 3))
        # Exactness at this size: in f32 the two paths' rounding makes their LM
        # trajectories part after a few steps (a step rejected by one, accepted
        # by the other), and each stops at its own point of the valley; in f64
        # both follow one trajectory, and their chi2 must agree.
        t0 = time.perf_counter()
        _, info_64 = solve_auto(g_2k64, opts16)
        wall_64 = time.perf_counter() - t0
        _, info_64d = schur.solve_schur(g_2k64, opts16, mode="dense")
        c64, c64d = info_64.chi2.item(), info_64d.chi2.item()
        log(f"landmark_slam_2d(2000, 300) f64: schur_sparse chi2 {c64!r} in {info_64.iterations} LM iterations "
            f"({1e3 * wall_64!r} ms), dense Schur {c64d!r} in {info_64d.iterations}; rel {abs(c64 - c64d) / c64d!r}")
        check(route_auto(g_2k64) == "schur_sparse" and info_64.iterations == info_64d.iterations
              and abs(c64 - c64d) <= 1e-4 * c64d, f"schur_sparse_2000 f64: chi2 {c64} vs dense Schur {c64d}")
        # one linear step at the start point, in f32 by both factorizations and
        # in f64 by both: each f32 step's distance from the f64 one
        tables = schur_sparse.plan_tables(ss_plan, dev)
        opt_lm = Options(method="lm")
        steps = {}
        for dtype, g_ in ((torch.float32, g_2k), (torch.float64, g_2k64)):
            parts_, grad_, _ = schur.ba_assemble(g_)
            lam_ = torch.tensor(1e-4, dtype=dtype, device=dev)
            steps[dtype] = (schur_sparse.schur_solve_sparse(parts_, grad_, lam_, opt_lm, ss_plan, tables),
                            schur.schur_solve_dense(parts_, grad_, lam_, opt_lm))
        exact = steps[torch.float64][1]

        def step_err(dx):
            return ((dx.double() - exact).norm() / exact.norm()).item()

        errs = {f"{k} {str(dt).split('.')[-1]}": step_err(steps[dt][i]) for dt in steps for i, k in enumerate(("sparse", "dense"))}
        log(f"landmark_slam_2d(2000, 300) first LM step, relative distance from the f64 dense Schur step: {errs}")
        check(errs["sparse float64"] <= 1e-8, f"schur_sparse_2000: the f64 step is {errs['sparse float64']} from dense")
        # slot_reduce at the assemble_S_ell plan, on the first linear system's blocks
        parts_2k, _, _ = schur.ba_assemble(g_2k)
        Hpp_2k, Hll_inv_2k, W_2k, _ = schur._schur_reduce(parts_2k, torch.tensor(1e-4, device=dev), "lm")
        Cp = W_2k[tables.pair_a] @ Hll_inv_2k[tables.pair_l] @ W_2k[tables.pair_b].transpose(-1, -2)
        PP_2k = parts_2k["PP"]
        contrib = torch.cat([Hpp_2k, PP_2k, PP_2k.transpose(-1, -2), -Cp]).reshape(-1, 9).contiguous()
        log(f"schur_sparse assemble_S_ell: contributions {tuple(contrib.shape)} into {tables.n_slots} ELL slots")
        check_kernel("slot_reduce", *slot_fns(tables.longest),
                     [contrib, tables.perm, tables.offsets, tables.n_slots], report, "schur_sparse_ms",
                     flop=contrib.numel(), library=index_add_library(contrib, tables.perm, tables.offsets, tables.n_slots))
        del parts_2k, Cp, contrib, steps, exact

        # ---- phase 17: solve_batched, a fleet of 16 config-1-size graphs -------
        fleet = [build.pose_graph(synth.se2_loop(n_poses=100, n_loops=12, seed=s)) for s in range(16)]
        opts17 = Options(method="lm", max_iters=50)
        solve_batched(fleet, opts17)[1].sum().item()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (values_f, chi2_f, info_f), launches, reads = drive(
            "batched_fleet_16", lambda: solve_batched(fleet, opts17, return_info=True), ("slot_reduce",))
        chi2_f = chi2_f.tolist()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        singles = [solve(g, opts17)[1] for g in fleet]
        single_chi2 = [i.chi2.item() for i in singles]
        wall_single = time.perf_counter() - t0
        log(f"solve_batched 16 x se2_loop(100) f32: wall {1e3 * wall!r} ms (16 single solves {1e3 * wall_single!r} ms), "
            f"LM iterations {info_f.iterations} (single {[i.iterations for i in singles]}), host reads {reads}, "
            f"launches {launches}, chi2 {chi2_f}")
        check(reads == {"pcg": 0, "lm": max(info_f.iterations)}, f"batched_fleet_16: host reads {reads}")
        check(tuple(values_f["poses"].shape) == (16, 100, 3, 3) and torch.isfinite(values_f["poses"]).all().item(),
              "batched_fleet_16: values")
        # In f32 the fleet and a single solve factor H in other kernels
        # (cuSOLVER's batched and single Cholesky) and sum each cost in another
        # order: their steps differ by the f32 rounding of an ill-conditioned
        # solve, and where the 1% decrease rule stops each is decided by that
        # rounding (on an H100: problem 9 stopped after 6 iterations in the
        # fleet and ran to the cap of 50 alone, problem 2 ended 1.8e-5 apart
        # after 2 iterations each).  So f32 holds each chi2 to 1e-4 of its
        # single solve; in f64 each problem follows its single solve step for
        # step.
        for b, ref in enumerate(singles):
            check(abs(chi2_f[b] - single_chi2[b]) <= 1e-4 * single_chi2[b],
                  f"batched_fleet_16 problem {b}: chi2 {chi2_f[b]}, single solve {single_chi2[b]}")
        fleet64 = [build.pose_graph(synth.se2_loop(n_poses=100, n_loops=12, seed=s), dtype=torch.float64)
                   for s in range(16)]
        _, chi2_64, info_64f = solve_batched(fleet64, opts17, return_info=True)
        singles64 = [solve(g, opts17)[1] for g in fleet64]
        for b, ref in enumerate(singles64):
            check(info_64f.iterations[b] == ref.iterations and info_64f.status[b] == ref.status
                  and info_64f.accepted[b].tolist() == ref.accepted.tolist()
                  and abs(chi2_64[b].item() - ref.chi2.item()) <= 1e-10 * ref.chi2.item(),
                  f"batched_fleet_16 f64 problem {b}: {info_64f.iterations[b]} iterations, chi2 {chi2_64[b].item()}; "
                  f"single solve {ref.iterations}, {ref.chi2.item()}")
        log(f"solve_batched 16 x se2_loop(100) f64: LM iterations {info_64f.iterations}, each problem's iterations, "
            f"stop code and accept sequence those of its single solve, chi2 within 1e-10")

        # ---- phase 18: f64 cross-checks of the sparse paths, CPU vs card -------
        loop60 = synth.se2_loop(n_poses=60, n_loops=10, seed=3)
        res = {where: sparse_chol.solve_sparse_chol(build.pose_graph(loop60, dtype=torch.float64, device=where),
                                                    Options(method="lm", max_iters=30))[::-1]
               for where in ("cpu", "cuda")}
        cross_check("se2_loop(60) solve_sparse_chol", res)
        lm40 = synth.landmark_slam_2d(n_poses=40, n_landmarks=25, max_range=8.0, seed=3)
        res = {where: schur_sparse.solve_schur_sparse(build.landmark_slam_2d(lm40, dtype=torch.float64, device=where),
                                                      Options(method="lm", max_iters=30), leaf_size=8)[::-1]
               for where in ("cpu", "cuda")}
        cross_check("landmark_slam_2d(40, 25) solve_schur_sparse", res)
        log(f"phases 1-18: {time.perf_counter() - t_start!r} s")

        # ---- phase 19: Venice-mini (config 5's problem) through solve_schur_large
        t_phase = time.perf_counter()
        vm = synth.ba_synthetic(n_cams=300, n_pts=60000, obs_per_pt=6, seed=0)
        g_vm = build.ba_graph(vm)
        opts_vm = Options(method="lm", max_iters=15)

        def run_vm(**kw):
            solved, chi2, hist = schur_large.solve_schur_large(g_vm, opts_vm, **kw)
            return solved, chi2, hist, solved.blocks["poses"].values[0, 0, 0].item()

        for linear_vm, kw_vm in (("pcg", dict(pcg_rtol=1e-4, pcg_max_iters=30)), ("dense", dict(linear="dense"))):
            path = f"venice_mini_{linear_vm}"
            run_vm(**kw_vm)  # warm-up
            torch.cuda.reset_peak_memory_stats()
            schur_large.reset_cg_iterations()
            t0 = time.perf_counter()
            (solved_vm, chi2_vm, hist_vm, _), launches, reads = drive(path, lambda: run_vm(**kw_vm), ("slot_reduce",))
            wall = time.perf_counter() - t0
            cg = schur_large.cg_iterations()
            log(f"solve {path} f32 (300 cameras, 60,000 points, {g_vm.batches[0].n} observations): wall {1e3 * wall!r} "
                f"ms, LM iterations {reads['lm'] - 1}, accepted {len(hist_vm) - 1}, chi2 {hist_vm[0]!r} -> {chi2_vm!r}, "
                f"CG iterations per linear solve {cg}, host reads {reads}, launches {launches}, peak memory "
                f"{torch.cuda.max_memory_allocated()} B")
            if linear_vm == "pcg":
                gate("venice_mini f32 pcg", chi2_vm, 1.001, standin["venice_mini_ref"]["chi2"])
                chi2_vm_pcg = chi2_vm  # config 5's path is held to it (phase 24)
            else:
                check(np.isfinite(chi2_vm) and chi2_vm < 0.01 * hist_vm[0], f"{path}: chi2 {hist_vm[0]} -> {chi2_vm}")
            check_poses(path, solved_vm, (300, 4, 4))
        # the settings that produced venice_mini_ref (scripts/venice_mini_ref.py), in f64
        t0 = time.perf_counter()
        _, chi2_vm64, hist_vm64 = schur_large.solve_schur_large(
            build.ba_graph(vm, dtype=torch.float64), Options(method="lm", max_iters=60, min_cost_decrease=1.0 - 1e-9),
            n_chunks=16, linear="dense")
        ref_vm = standin["venice_mini_ref"]["chi2"]
        gap_vm = abs(chi2_vm64 - ref_vm) / ref_vm
        log(f"venice_mini f64 dense to convergence: chi2 {chi2_vm64!r} in {len(hist_vm64) - 1} accepted steps "
            f"({time.perf_counter() - t0!r} s); venice_mini_ref {ref_vm!r}, relative gap {gap_vm!r}")
        check(gap_vm <= 1e-6, f"venice_mini f64 dense: chi2 {chi2_vm64} is {gap_vm} from {ref_vm}")
        log(f"phase 19 (Venice-mini): {time.perf_counter() - t_phase!r} s")

        # ---- phase 20: bench config 6 at full size ------------------------------
        t_phase = time.perf_counter()
        t0 = time.perf_counter()
        v6 = synth.ba_synthetic(n_cams=1700, n_pts=1_000_000, obs_per_pt=5, seed=0)
        t_data = time.perf_counter() - t0
        t0 = time.perf_counter()
        g_6 = build.ba_graph(v6)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        n_obs6 = g_6.batches[0].n
        check((g_6.blocks["poses"].n, g_6.blocks["landmarks"].n, n_obs6) == (1700, 1_000_000, 4_650_850),
              f"config6: {g_6.blocks['poses'].n} cameras, {g_6.blocks['landmarks'].n} points, {n_obs6} observations")
        route_6 = route_auto(g_6)
        check(route_6 == "schur_large", f"config6: route {route_6!r}, expected 'schur_large'")
        common6 = dict(n_chunks=128, pcg_rtol=1e-4, pcg_max_iters=12)
        t0 = time.perf_counter()
        plan_6 = schur_large.prepare_large_ba(g_6, common6["n_chunks"])
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        t0 = time.perf_counter()
        schur_large.solve_schur_large(g_6, Options(method="lm", max_iters=1), plan=plan_6, **common6)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        log(f"config6: data {t_data!r} s, ba_graph {t_build!r} s, prepare_large_ba {t_plan!r} s, warm-up (one LM "
            f"iteration) {t_warm!r} s; route {route_6!r}")
        opts6 = Options(method="lm", max_iters=10)

        def run_6():
            solved, chi2, hist = schur_large.solve_schur_large(g_6, opts6, plan=plan_6, **common6)
            torch.cuda.synchronize()
            return solved, chi2, hist, solved.blocks["poses"].values[0, 0, 0].item()

        torch.cuda.reset_peak_memory_stats()
        schur_large.reset_cg_iterations()
        t0 = time.perf_counter()
        (solved_6, chi2_6, hist_6, _), launches, reads = drive("config6_venice", run_6, ("slot_reduce",))
        wall6 = time.perf_counter() - t0
        peak6 = torch.cuda.max_memory_allocated()
        cg6 = schur_large.cg_iterations()
        iters6 = len(cg6)
        g_gt = build.ba_graph(v6, init="gt")
        chi2_gt = schur_large._cost(plan_6, g_gt.blocks["poses"].values, g_gt.blocks["landmarks"].values).item()
        del g_gt
        log(f"solve config6 f32 (1,700 cameras, 1,000,000 points, {n_obs6} observations; n_chunks 128, PCG 1e-4 / 12, "
            f"LM 10): wall {wall6!r} s, LM iterations {iters6}, accepted {len(hist_6) - 1} (rejected "
            f"{iters6 - len(hist_6) + 1}), s per LM iteration {wall6 / max(iters6, 1)!r}, s per accepted step "
            f"{wall6 / max(len(hist_6) - 1, 1)!r}, chi2 {hist_6!r}, ground-truth chi2 {chi2_gt!r}, CG iterations per "
            f"linear solve {cg6}, host reads {reads}, launches {launches}, peak memory {peak6} B")
        gate("config6 venice_full_conv", chi2_6, 1.001, standin["venice_full_conv"]["chi2"])
        check_poses("config6", solved_6, (1700, 4, 4))
        check(torch.isfinite(solved_6.blocks["landmarks"].values).all().item(), "config6: non-finite landmarks")
        # the dispatch runs the route (one LM iteration, the plan built inside)
        (auto_6, hist_auto), launches, reads = drive(
            "config6_solve_auto", lambda: solve_auto(g_6, Options(method="lm", max_iters=1)), ("slot_reduce",))
        log(f"config6 solve_auto (max_iters 1): history {hist_auto!r}, launches {launches}, host reads {reads}")
        check(len(hist_auto) >= 1 and np.isfinite(hist_auto[-1]) and hist_auto[-1] <= hist_6[0],
              f"config6 solve_auto: history {hist_auto}")
        del auto_6, solved_6
        log(f"phase 20 (config 6): {time.perf_counter() - t_phase!r} s")
        config6 = dict(g_6=g_6, plan_6=plan_6, common6=common6, chi2_6=chi2_6, cg6=cg6, wall6=wall6, peak6=peak6,
                       iters6=iters6)

        # ---- phase 21: slot_reduce at the Venice shapes -------------------------
        # The sums of config 6 by camera (4,650,850 rows into 1,700: the 27 terms
        # of a linearization, the 21 of D, the 6 of a Schur product) and by
        # landmark (into 1,000,000: 9 and 3), on rows drawn from a seeded
        # generator on the card.
        t_phase = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for seg, width in ((plan_6.by_cam, 27), (plan_6.by_cam, 21), (plan_6.by_cam, 6), (plan_6.by_lm, 9),
                           (plan_6.by_lm, 3)):
            contrib = torch.randn((n_obs6, width), generator=gen, device=dev)
            check_slot_plan(f"config6_C{width}", contrib, seg, report)
            del contrib
        del plan_6, g_6, v6  # phases 49 and 50 keep them in ``config6``
        if not want(49, 50):
            config6 = None
        torch.cuda.empty_cache()
        log(f"phase 21 (slot_reduce at the Venice shapes): {time.perf_counter() - t_phase!r} s")

        # ---- phase 22: f64 cross-check of solve_schur_large, CPU vs card ------
        ba_s = synth.ba_synthetic(n_cams=8, n_pts=64, seed=3)
        res = {where: schur_large.solve_schur_large(build.ba_graph(ba_s, dtype=torch.float64, device=where),
                                                    Options(method="lm", max_iters=12), n_chunks=4)
               for where in ("cpu", "cuda")}
        (s_c, c_c, h_c), (s_g, c_g, h_g) = res["cpu"], res["cuda"]
        pose_err = (s_c.blocks["poses"].values - s_g.blocks["poses"].values.cpu()).abs().max().item()
        log(f"f64 ba_synthetic(8, 64) solve_schur_large: cpu {h_c!r}; cuda {h_g!r}; pose diff {pose_err!r}")
        check(len(h_c) == len(h_g) and abs(c_c - c_g) <= 1e-8 * c_c and pose_err <= 1e-6,
              "solve_schur_large: the CPU and CUDA paths differ")
    ctx = dict(dev=dev, drive=drive, gate=gate, check_poses=check_poses, report=report, standin=standin,
               chi2_ref=chi2_ref, sphere=graph, x_sphere=x, sphere_data=data, m3500=m3500, want=want,
               selected=phases is not None, smi=smi_line)
    if run_main:
        ctx.update(g_vm=g_vm, chi2_vm_pcg=chi2_vm_pcg, g_7=g_7, chi2_7=chi2_7, sphere_solved=sphere_solved,
                   config6=config6)
    covariance_phases(ctx)
    if want(50, 51):
        precond_phases(ctx)
    if want(*range(23, 28), 40, 49):
        sharded_phases(ctx)
    ctx.pop("config6", None)
    torch.cuda.empty_cache()
    if want(*range(28, 32)):
        robust_init_vio_phases(ctx)
    online_phases(ctx)
    later_covariance_phases(ctx)
    api_phases(ctx)
    vo_phases(ctx)
    if want(52):
        io_phase(ctx)
    log(f"total: {time.perf_counter() - t_start!r} s")
    log(json.dumps({"slot_reduce_bodies_by_path": bodies_by_path}))
    against_parent.close()
    if cli.parent:
        time_moved_bodies(moved, parent_cuda_ops(cli.parent))

    sources = {"ell_matvec": "pyslam_tpu_torch/csrc/ell_matvec.cu",
               "ell_pcg": "pyslam_tpu_torch/csrc/ell_pcg.cu",
               "slot_reduce": "pyslam_tpu_torch/csrc/slot_reduce.cu",
               "ell_assemble": "pyslam_tpu_torch/csrc/ell_assemble.cu",
               "bal_rows": "pyslam_tpu_torch/csrc/bal_rows.cu"}
    # ell_pcg is ell_matvec_lane_major at the grain of its caller, the
    # while_loop of pyslam_tpu/solver/linear.py:38-61; ell_assemble is
    # scatter_matmul at the grain of its caller, assemble_ell of
    # pyslam_tpu/solver/bcsr.py:410-439
    replaces = {"ell_matvec": "pyslam_tpu/solver/pallas_ops.py:60",
                "ell_pcg": "pyslam_tpu/solver/pallas_ops.py:60",
                "slot_reduce": "pyslam_tpu/solver/pallas_ops.py:143",
                "ell_assemble": "pyslam_tpu/solver/pallas_ops.py:143",
                # the reference linearizes BAL observations with the factor
                # kernel's tensor ops, chunk by chunk; no Pallas kernel
                "bal_rows": "none: the chunked factor kernel of schur_large._obs_rows (library_ms)"}
    main_paths = ("sphere2500", "sphere2500_dogleg", "config1_se2_loop_cauchy", "config1_se2_loop_l2",
                  "config2_m3500_g2o", "config7_sim3_400", "config4_ba_schur_pcg", "config4_ba_schur_dense",
                  "config8_landmark_slam_800", "config2_sparse_chol", "sparse_chol_5000", "schur_sparse_2000",
                  "batched_fleet_16", "venice_mini_pcg", "venice_mini_dense", "config6_venice", "config6_solve_auto",
                  "config5_schur_sharded", "sphere2500_pose_sharded", "config7_factor_parallel",
                  "init_chordal_sphere2500", "init_chordal_m3500",
                  *(f"{g}_from_{i}" for g in ("sphere2500", "m3500") for i in ("odometry", "spanning_tree", "chordal")),
                  "gnc_sphere2500", "switchable_m3500_float32", "switchable_m3500_float64", "vio400",
                  "vio_window", *(f"fixed_lag_{c}_{t}" for c in ("sphere2500", "lm_config8") for t in ("float64", "float32")),
                  "incremental_m3500", "sqrt_ladybug_float64", "sqrt_ladybug_solve_auto", *COVARIANCE_PATHS,
                  "problem_sphere2500", "problem_covariance_f32", "problem_covariance_f64", "implicit_m3500",
                  "implicit_m3500_backward", "autodiff_sphere2500", "vo_rgbd_vga", "vo_rgbd_vga_batch16",
                  "vo_stereo_vga", "stereo_slam_40", "schur_cm_config5", "schur_cm_config6", "cluster64_config6",
                  "stale_config6", "two_level_sphere2500", "venice_ba_bal_rows", "bal_final13682_bal_rows9",
                  *BCSR_PATHS.values())
    # a phase selection reports the kernels and paths it ran; the default run
    # must have every kernel, launched on a main path, with every column
    kernels = [
        dict(name=k, route="cuda", source=sources[k], replaces=replaces[k],
             launches=sum(launches_by_path.get(p, {}).get(k, 0) for p in main_paths),
             launches_by_path={p: launches_by_path[p][k] for p in main_paths if k in launches_by_path.get(p, {})},
             **report[k])
        for k in KERNELS if k in report
    ]
    for k in kernels if phases is None else ():
        check(k["launches"] > 0, f"kernel {k['name']} was launched on no main path")
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
            check(key in k, f"kernel {k['name']}: no {key}")
    check(phases is not None or len(kernels) == len(KERNELS), "a kernel is missing from the report")
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


def sharded_bsr(He, cols, start, n_x):
    """The rows of one rank's sharded ELL store as a
    ``torch.sparse_bsr_tensor`` against the x of every rank (padding slots,
    whose column is the row itself, dropped; columns ascending), for the
    library yardstick of ``ell_matvec`` at the sharded shape."""
    import numpy as np
    import torch

    nb_local, K, d, _ = He.shape
    c = cols.cpu().numpy().astype(np.int64)
    valid = np.ones_like(c, bool)
    valid[:, 1:] = c[:, 1:] != (start + np.arange(nb_local))[:, None]
    order = np.argsort(np.where(valid, c, np.iinfo(np.int64).max), axis=1, kind="stable")
    keep = np.take_along_axis(valid, order, axis=1)
    col = np.take_along_axis(c, order, axis=1)[keep]
    crow = np.concatenate([[0], np.cumsum(valid.sum(1))])
    flat = torch.from_numpy((np.arange(nb_local)[:, None] * K + order)[keep]).to(He.device)
    return torch.sparse_bsr_tensor(torch.from_numpy(crow).to(He.device), torch.from_numpy(col).to(He.device),
                                   He.reshape(-1, d, d)[flat].contiguous(), size=(nb_local * d, n_x * d))


def _two_ranks_on_one_card(mesh):
    """Phase 27's rank: the two collectives on CUDA tensors over gloo, then
    config 4's graph through ``solve_schur_sharded``, ``solve_schur_cm`` and
    ``solve_auto`` (route ``schur_cm``), and a 500-pose sphere through
    ``solve_pose_sharded``."""
    import torch

    from pyslam_tpu_torch import dist, solver
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import cuda_ops
    from pyslam_tpu_torch.solver.lm import Options

    dev = mesh.device
    t = mesh.psum(torch.full((3,), float(mesh.rank + 1), device=dev))
    gathered = mesh.all_gather(torch.full((mesh.rank + 1, 2), float(mesh.rank), device=dev), [1, 2])
    out = dict(backend=mesh.backend, device=str(t.device), psum=t.tolist(), gathered=gathered.tolist())
    cuda_ops.reset_launches()
    g_4 = build.ba_graph(synth.ba_synthetic(n_cams=49, n_pts=7000, seed=0))
    _, out["chi2_ba"], out["hist_ba"] = dist.solve_schur_sharded(g_4, mesh, Options(method="lm", max_iters=25),
                                                                 pcg_rtol=1e-4, pcg_max_iters=30)
    # the component-major path at its defaults (8 chunks, PCG 1e-4 / 30), then
    # solve_auto with the crossover lowered, which must route it there
    _, out["chi2_cm"], out["hist_cm"] = dist.solve_schur_cm(g_4, mesh, Options(method="lm", max_iters=25))
    out["route"] = solver.route_auto(g_4, mesh=mesh, cm_obs_crossover=10)
    _, out["hist_auto"] = solver.solve_auto(g_4, Options(method="lm", max_iters=25), mesh=mesh, cm_obs_crossover=10)
    _, out["chi2_pose"], out["hist_pose"] = dist.solve_pose_sharded(
        build.pose_graph(synth.se3_sphere(n_poses=500, seed=0)), mesh,
        Options(method="lm", max_iters=30, min_cost_decrease=0.999), pcg_rtol=3e-6, pcg_max_iters=120)
    out["launches"] = dict(cuda_ops.LAUNCHES)
    return out


def sharded_phases(ctx):
    """Phases 23 to 27 and 40: the multi-device layer (``dist/``) on the card.
    ``ctx`` carries what ``main`` built and measured before: the device,
    its helpers (``drive``, ``gate``, ``check_poses``), the kernels report,
    the reference costs, the Venice-mini graph and phase 19's PCG chi2,
    sphere2500's graph and random x, config 7's graph and phase 8's chi2."""
    import tempfile

    import torch
    import torch.distributed as tdist

    from pyslam_tpu_torch import dist
    from pyslam_tpu_torch.dist import pose_sharded, schur_reduce
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import cuda_ops, schur_large
    from pyslam_tpu_torch.solver.lm import Options
    from pyslam_tpu_torch.testing import run_ranks

    dev, drive, gate, check_poses, report = (ctx[k] for k in ("dev", "drive", "gate", "check_poses", "report"))
    standin, want = ctx["standin"], ctx["want"]
    with tempfile.TemporaryDirectory() as store:
        try:
            # ---- phase 23: a process group of one rank on NCCL -------------
            t_phase = time.perf_counter()
            dist.init_distributed(f"file://{os.path.join(store, 'world')}", world_size=1, rank=0)
            mesh = dist.make_mesh(axis_name="l")
            ones = mesh.psum(torch.arange(3.0, device=dev))
            check(mesh.backend == "nccl" and mesh.size == 1 and mesh.device.type == "cuda"
                  and torch.equal(ones, torch.arange(3.0, device=dev)), f"process group: {mesh}")
            mesh.barrier()
            log(f"process group: backend {mesh.backend}, world size {mesh.size}, rank {mesh.rank}, device "
                f"{mesh.device}, NCCL {torch.cuda.nccl.version()}; {time.perf_counter() - t_phase!r} s")

            if want(24):
                # ---- phase 24: bench config 5 through solve_schur_sharded -------
                # phase 19's Venice-mini graph, the settings of bench/run.py:249-262
                t_phase = time.perf_counter()
                g_vm = ctx["g_vm"]
                opts5 = Options(method="lm", max_iters=15)

                def run5():
                    return dist.solve_schur_sharded(g_vm, mesh, opts5, pcg_rtol=1e-4, pcg_max_iters=30)

                t0 = time.perf_counter()
                run5()  # warm-up
                torch.cuda.synchronize()
                warm = time.perf_counter() - t0
                torch.cuda.reset_peak_memory_stats()
                schur_large.reset_cg_iterations()
                dist.reset_collectives()
                t0 = time.perf_counter()
                (solved5, chi2_5, hist5), launches, reads = drive("config5_schur_sharded", run5, ("slot_reduce",))
                wall = time.perf_counter() - t0
                coll, cg5, peak = dict(dist.COLLECTIVES), schur_large.cg_iterations(), torch.cuda.max_memory_allocated()
                iters = len(cg5)
                log(f"solve config5_schur_sharded f32 (300 cameras, 60,000 points, {g_vm.batches[0].n} observations, "
                    f"1 rank): wall {1e3 * wall!r} ms (warm-up {1e3 * warm!r} ms), LM iterations {iters}, accepted "
                    f"{len(hist5) - 1}, chi2 {hist5[0]!r} -> {chi2_5!r}, CG iterations per linear solve {cg5}, host "
                    f"reads {reads}, launches {launches}, collectives {coll}, peak memory {peak} B")
                gate("config5 venice_mini through solve_schur_sharded", chi2_5, 1.001, standin["venice_mini_ref"]["chi2"])
                gap = abs(chi2_5 - ctx["chi2_vm_pcg"]) / ctx["chi2_vm_pcg"]
                log(f"config5: solve_schur_large's chi2 {ctx['chi2_vm_pcg']!r}, relative gap {gap!r}")
                check(gap <= 1e-4, f"config5: chi2 {chi2_5} is {gap} from solve_schur_large's")
                check(reads == {"pcg": 0, "lm": iters}, f"config5: host reads {reads}, expected one per LM iteration")
                check(coll == {"psum": iters * (4 + 30), "all_gather": 1}, f"config5: collectives {coll}")
                check_poses("config5", solved5, (300, 4, 4))
                check(torch.isfinite(solved5.blocks["landmarks"].values).all().item(), "config5: non-finite landmarks")
                del solved5
                ctx.update(chi2_5=chi2_5, peak_5=peak, wall_5=wall)  # phase 49 is held to them

                # slot_reduce at config 5's sums, on the rank's plans: the rows of
                # the linearization at the start point by camera (6 + 36) and by
                # landmark (3 + 9), then seeded rows at the widths of g_red (6)
                # and D (36) by camera and of a Schur product (6 by camera, 3 by
                # landmark)
                sb = dist.shard_ba(g_vm, mesh)
                r, (Jc, Jl) = schur_reduce._observations(sb, sb.poses, sb.lms, True)
                w = sb.loss.weight(r) * sb.weight[:, None]
                rows5 = (schur_reduce._rows(Jc, w, w * r), schur_reduce._rows(Jl, w, w * r))
                del r, Jc, Jl, w
                gen = torch.Generator(device=dev).manual_seed(SEED)
                M5 = rows5[0].shape[0]
                for label, contrib, seg in (("linearization by camera", rows5[0], sb.by_cam),
                                            ("linearization by landmark", rows5[1], sb.by_lm),
                                            ("g_red by camera", torch.randn((M5, 6), generator=gen, device=dev), sb.by_cam),
                                            ("D by camera", torch.randn((M5, 36), generator=gen, device=dev), sb.by_cam),
                                            ("S product, by landmark", torch.randn((M5, 3), generator=gen, device=dev),
                                             sb.by_lm),
                                            ("S product, by camera", torch.randn((M5, 6), generator=gen, device=dev),
                                             sb.by_cam)):
                    log(f"config5 {label}: contributions {tuple(contrib.shape)} into {seg.n_slots} destinations")
                    check_kernel("slot_reduce", *slot_fns(seg.longest),
                                 [contrib, seg.perm, seg.offsets, seg.n_slots], report, "config5_ms", flop=contrib.numel(),
                                 library=index_add_library(contrib, seg.perm, seg.offsets, seg.n_slots))
                del sb, rows5, contrib
                log(f"phase 24 (config 5): {time.perf_counter() - t_phase!r} s")

            if want(25):
                # ---- phase 25: sphere2500 through solve_pose_sharded ------------
                t_phase = time.perf_counter()
                sphere = ctx["sphere"]
                mesh_p = dist.make_mesh(axis_name="p")
                opts25 = Options(method="lm", max_iters=30, min_cost_decrease=0.999)

                def run25():
                    return dist.solve_pose_sharded(sphere, mesh_p, opts25, pcg_rtol=3e-6, pcg_max_iters=120)

                run25()
                torch.cuda.synchronize()
                dist.reset_collectives()
                t0 = time.perf_counter()
                (solved25, chi2_25, hist25), launches, reads = drive("sphere2500_pose_sharded", run25,
                                                                     ("ell_matvec", "slot_reduce"))
                wall = time.perf_counter() - t0
                coll, iters = dict(dist.COLLECTIVES), reads["lm"]
                log(f"solve sphere2500_pose_sharded f32 (1 rank): wall {1e3 * wall!r} ms, LM iterations {iters}, "
                    f"accepted {len(hist25) - 1}, chi2 {hist25[0]!r} -> {chi2_25!r}, ell_matvec launches "
                    f"{launches['ell_matvec']}, host reads {reads}, launches {launches}, collectives {coll}")
                gate("sphere2500 through solve_pose_sharded", chi2_25, 1.001, ctx["chi2_ref"])
                check(launches["ell_matvec"] == 120 * iters > 0 and reads["pcg"] == 0,
                      f"sphere2500_pose_sharded: {launches['ell_matvec']} ell_matvec launches for {iters} LM iterations")
                check_poses("sphere2500_pose_sharded", solved25, (N_POSES, 4, 4))

                # slot_reduce at the rank's assembly plans, on the rows of the
                # first linearization: Hessian blocks into the ELL store (36) and
                # gradient rows (6)
                sp1 = dist.shard_pose_graph(sphere, mesh_p)
                _, h_rows, g_rows = pose_sharded._contributions(sp1, mesh_p.all_gather(sp1.pose_slab, sp1.counts))
                for label, contrib, seg in (("Hessian blocks", h_rows, sp1.h_seg), ("gradient rows", g_rows, sp1.g_seg)):
                    log(f"sphere2500_pose_sharded {label}: contributions {tuple(contrib.shape)} into {seg.n_slots} "
                        f"destinations")
                    check_kernel("slot_reduce", *slot_fns(seg.longest),
                                 [contrib, seg.perm, seg.offsets, seg.n_slots], report, "pose_sharded_ms",
                                 flop=contrib.numel(), library=index_add_library(contrib, seg.perm, seg.offsets, seg.n_slots))
                del sp1, h_rows, g_rows
                log(f"phase 25 (sphere2500 sharded): {time.perf_counter() - t_phase!r} s")

                # ell_matvec at the sharded shape: rank 0 of 2's rows of sphere2500
                # (its BFS partition) against the whole x, on seeded random blocks
                two = dist.Mesh(group=None, rank=0, size=2, device=dev, backend="nccl", axis_name="p")
                sp = dist.shard_pose_graph(sphere, two)
                Pr, K = sp.cols.shape
                gen = torch.Generator(device=dev).manual_seed(SEED)
                He_s = torch.randn((Pr, K, 6, 6), generator=gen, device=dev)
                pad = (torch.arange(K, device=dev)[None, :] > 0) & (sp.cols.long() == torch.arange(Pr, device=dev)[:, None])
                He_s[pad] = 0.0  # padding slots hold zero blocks, as an assembled store does
                x_s = ctx["x_sphere"]
                bsr_s = sharded_bsr(He_s, sp.cols, 0, sp.nb)
                log(f"ell_matvec sharded shape: rows {Pr} of {sp.nb} (rank 0 of 2), K {K}, x {tuple(x_s.shape)}")
                check_kernel("ell_matvec", cuda_ops.ell_matvec, cuda_ops.ell_matvec_plain, [He_s, sp.cols, x_s], report,
                             "pose_sharded_ms", flop=2 * Pr * K * 36, library=lambda: (bsr_s @ x_s[:, None])[:, 0])

            if want(26):
                # ---- phase 26: config 7 through solve_factor_parallel -----------
                t_phase = time.perf_counter()
                mesh_f = dist.make_mesh()
                opts7 = Options(method="lm", max_iters=50)

                def run26():
                    return dist.solve_factor_parallel(ctx["g_7"], mesh_f, opts7)

                run26()
                torch.cuda.synchronize()
                dist.reset_collectives()
                t0 = time.perf_counter()
                (solved26, chi2_26, hist26), launches, reads = drive("config7_factor_parallel", run26, ("slot_reduce",))
                wall = time.perf_counter() - t0
                coll = dict(dist.COLLECTIVES)
                gap = abs(chi2_26 - ctx["chi2_7"]) / ctx["chi2_7"]
                log(f"solve config7_factor_parallel f32 (1 rank): wall {1e3 * wall!r} ms, LM iterations {reads['lm']}, "
                    f"chi2 {hist26[0]!r} -> {chi2_26!r}; the dense path's {ctx['chi2_7']!r}, relative gap {gap!r}; "
                    f"launches {launches}, collectives {coll}")
                gate("config7 sim3_loop_400 through solve_factor_parallel", chi2_26, STANDIN_GATE,
                     standin["sim3_loop_400"]["chi2"])
                check(gap <= 1e-4, f"config7_factor_parallel: chi2 {chi2_26} is {gap} from the dense path's")
                check(coll == {"psum": 3 * reads["lm"], "all_gather": 0}, f"config7_factor_parallel: collectives {coll}")
                check_poses("config7_factor_parallel", solved26, (400, 4, 4))
                log(f"phase 26 (config 7 factor-parallel): {time.perf_counter() - t_phase!r} s")

            if want(27):
                # ---- phase 27: two ranks on the one card, over gloo -------------
                # NCCL refuses two ranks on one GPU; gloo takes CUDA tensors.  The
                # same two solves at world size 1 (this process, NCCL) first.
                t_phase = time.perf_counter()
                g_4 = build.ba_graph(synth.ba_synthetic(n_cams=49, n_pts=7000, seed=0))
                _, ref_ba, _ = dist.solve_schur_sharded(g_4, mesh, Options(method="lm", max_iters=25), pcg_rtol=1e-4,
                                                        pcg_max_iters=30)
                _, ref_cm, _ = dist.solve_schur_cm(g_4, mesh, Options(method="lm", max_iters=25))
                _, ref_pose, _ = dist.solve_pose_sharded(build.pose_graph(synth.se3_sphere(n_poses=500, seed=0)), mesh,
                                                         Options(method="lm", max_iters=30, min_cost_decrease=0.999),
                                                         pcg_rtol=3e-6, pcg_max_iters=120)
                os.mkdir(os.path.join(store, "two"))
                ranks = run_ranks(_two_ranks_on_one_card, 2, os.path.join(store, "two"), backend="gloo", device="cuda",
                                  timeout_s=300.0)
                for rank, out in enumerate(ranks):
                    gap_ba, gap_pose = (abs(out["chi2_ba"] - ref_ba) / ref_ba, abs(out["chi2_pose"] - ref_pose) / ref_pose)
                    log(f"two ranks on one card, rank {rank}: {out['backend']} on {out['device']}, psum {out['psum']}, "
                        f"gather {out['gathered']}; config4 chi2 {out['chi2_ba']!r} (1 rank {ref_ba!r}, gap {gap_ba!r}, "
                        f"{len(out['hist_ba']) - 1} accepted); se3_sphere(500) chi2 {out['chi2_pose']!r} (1 rank "
                        f"{ref_pose!r}, gap {gap_pose!r}); launches {out['launches']}")
                    check(out["backend"] == "gloo" and out["device"].startswith("cuda") and out["psum"] == [3.0] * 3
                          and out["gathered"] == [[0.0, 0.0], [1.0, 1.0], [1.0, 1.0]], f"rank {rank}: gloo on the card")
                    check(gap_ba <= 1e-4 and gap_pose <= 1e-4, f"rank {rank}: two ranks part from one")
                    gap_cm = abs(out["chi2_cm"] - ref_cm) / ref_cm
                    log(f"two ranks on one card, rank {rank}: config4 through solve_schur_cm chi2 {out['chi2_cm']!r} "
                        f"(1 rank {ref_cm!r}, gap {gap_cm!r}, {len(out['hist_cm']) - 1} accepted); solve_auto's route "
                        f"{out['route']!r}, its history {out['hist_auto']!r}")
                    check(gap_cm <= 1e-4, f"rank {rank}: solve_schur_cm on two ranks parts from one")
                    check(out["route"] == "schur_cm" and out["hist_auto"] == out["hist_cm"],
                          f"rank {rank}: solve_auto did not solve through schur_cm")
                    check(out["launches"]["slot_reduce"] > 0 and out["launches"]["ell_matvec"] > 0
                          and out["launches"]["slot_reduce_plain"] == out["launches"]["ell_matvec_plain"] == 0,
                          f"rank {rank}: launches {out['launches']}")
                check(ranks[0]["chi2_ba"] == ranks[1]["chi2_ba"] and ranks[0]["chi2_pose"] == ranks[1]["chi2_pose"]
                      and ranks[0]["chi2_cm"] == ranks[1]["chi2_cm"], "the two ranks returned different solves")
                log(f"phase 27 (two ranks, one card): {time.perf_counter() - t_phase!r} s")

            # ---- phase 40: the sharded marginals, config 5's Venice-mini -----
            if want(40):
                sharded_marginals_phase(ctx, mesh)

            # ---- phase 49: configs 5 and 6 through solve_schur_cm ------------
            if want(49):
                schur_cm_phase(ctx, mesh)

        finally:
            if tdist.is_initialized():
                tdist.destroy_process_group()


def schur_cm_phase(ctx, mesh):
    """Phase 49, on the one-rank NCCL mesh: bench config 5 (Venice-mini,
    above the reference's 250,000-observation crossover) and config 6 at full
    size through ``dist.solve_schur_cm``, each under its gate, within 1e-4
    of ``solve_schur_large``'s chi2 (phases 19, 20) and config 5 also of
    ``solve_schur_sharded``'s (phase 24); 4 + CG budget ``psum`` and one
    host read an LM iteration; peak memory beside ``schur_reduce``'s and
    ``schur_large``'s; ``slot_reduce`` held at the rank's camera-sorted
    plans."""
    import torch

    from pyslam_tpu_torch import dist
    from pyslam_tpu_torch.solver import cuda_ops, schur_large
    from pyslam_tpu_torch.solver.lm import Options

    drive, gate, report, standin = (ctx[k] for k in ("drive", "gate", "report", "standin"))
    t_phase = time.perf_counter()
    g_vm = ctx["g_vm"]
    opts5 = Options(method="lm", max_iters=15)

    def run5():
        return dist.solve_schur_cm(g_vm, mesh, opts5, n_chunks=8, pcg_rtol=1e-4, pcg_max_iters=30)

    t0 = time.perf_counter()
    run5()  # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    schur_large.reset_cg_iterations()
    dist.reset_collectives()
    t0 = time.perf_counter()
    (solved, chi2, hist), launches, reads = drive("schur_cm_config5", run5, ("slot_reduce",))
    wall = time.perf_counter() - t0
    coll, cg, peak = dict(dist.COLLECTIVES), schur_large.cg_iterations(), torch.cuda.max_memory_allocated()
    iters = len(cg)
    gap_large = abs(chi2 - ctx["chi2_vm_pcg"]) / ctx["chi2_vm_pcg"]
    gap_reduce = abs(chi2 - ctx["chi2_5"]) / ctx["chi2_5"]
    log(f"solve schur_cm_config5 f32 (300 cameras, 60,000 points, {g_vm.batches[0].n} observations, 1 rank, 8 "
        f"chunks): wall {1e3 * wall!r} ms (warm-up {1e3 * warm!r} ms; solve_schur_sharded's {1e3 * ctx['wall_5']!r}), "
        f"LM iterations {iters}, accepted {len(hist) - 1}, chi2 {hist[0]!r} -> {chi2!r}; gaps to solve_schur_large "
        f"{gap_large!r}, to solve_schur_sharded {gap_reduce!r}; CG iterations per linear solve {cg}, host reads "
        f"{reads}, launches {launches}, collectives {coll} ({coll['psum'] / max(iters, 1)!r} psum an LM iteration, "
        f"the docstring's 4 + 30), peak memory {peak} B (schur_reduce's {ctx['peak_5']} B)")
    gate("config5 venice_mini through solve_schur_cm", chi2, 1.001, standin["venice_mini_ref"]["chi2"])
    check(gap_large <= 1e-4 and gap_reduce <= 1e-4, f"schur_cm_config5: gaps {gap_large}, {gap_reduce}")
    check(reads == {"pcg": 0, "lm": iters}, f"schur_cm_config5: host reads {reads}")
    check(coll == {"psum": iters * (4 + 30), "all_gather": 1}, f"schur_cm_config5: collectives {coll}")
    ctx["check_poses"]("schur_cm_config5", solved, (300, 4, 4))
    del solved

    # slot_reduce at the rank's camera-sorted plans: the linearization's rows
    # at the start point by camera (27) and by landmark (9)
    sb = dist.shard_ba_cm(g_vm, mesh, 8)
    _, rows = schur_large._obs_rows(sb.plan, sb.poses, sb.lms)
    for label, contrib, seg in (("by camera", rows[:, :27].contiguous(), sb.plan.by_cam),
                                ("by landmark", rows[:, 27:36].contiguous(), sb.plan.by_lm)):
        log(f"schur_cm config5 {label}: contributions {tuple(contrib.shape)} into {seg.n_slots} destinations")
        check_kernel("slot_reduce", *slot_fns(seg.longest),
                     [contrib, seg.perm, seg.offsets, seg.n_slots], report, "schur_cm_ms", flop=contrib.numel(),
                     library=index_add_library(contrib, seg.perm, seg.offsets, seg.n_slots), calls=20)
    del sb, rows, contrib

    # config 6 at full size: phase 20's graph, its settings
    c6 = ctx["config6"]
    g_6, common6 = c6["g_6"], c6["common6"]
    opts6 = Options(method="lm", max_iters=10)

    def run6():
        solved, chi2, hist = dist.solve_schur_cm(g_6, mesh, opts6, **common6)
        torch.cuda.synchronize()
        return solved, chi2, hist

    t0 = time.perf_counter()
    dist.shard_ba_cm(g_6, mesh, common6["n_chunks"])
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist.solve_schur_cm(g_6, mesh, Options(method="lm", max_iters=1), **common6)  # warm-up: plan and one iteration
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    schur_large.reset_cg_iterations()
    dist.reset_collectives()
    t0 = time.perf_counter()
    (solved, chi2, hist), launches, reads = drive("schur_cm_config6", run6, ("slot_reduce",))
    wall = time.perf_counter() - t0
    coll, cg, peak = dict(dist.COLLECTIVES), schur_large.cg_iterations(), torch.cuda.max_memory_allocated()
    iters = len(cg)
    gap = abs(chi2 - c6["chi2_6"]) / c6["chi2_6"]
    log(f"solve schur_cm_config6 f32 (1,700 cameras, 1,000,000 points, 4,650,850 observations, 1 rank; n_chunks 128, "
        f"PCG 1e-4 / 12, LM 10): wall {wall!r} s with the plan (shard_ba_cm alone {t_plan!r} s; warm-up {warm!r} s); "
        f"solve_schur_large's {c6['wall6']!r} s with its plan prebuilt; LM iterations {iters} "
        f"(solve_schur_large {c6['iters6']}), accepted {len(hist) - 1}, chi2 {hist!r}, gap to solve_schur_large "
        f"{gap!r}; CG iterations per linear solve {cg}; host reads {reads}, launches {launches}, collectives {coll}; "
        f"peak memory {peak} B with phase 20's graph and plan resident (solve_schur_large's peak {c6['peak6']} B)")
    gate("config6 venice_full_conv through solve_schur_cm", chi2, 1.001, standin["venice_full_conv"]["chi2"])
    check(gap <= 1e-4, f"schur_cm_config6: chi2 {chi2} is {gap} from solve_schur_large's")
    check(reads == {"pcg": 0, "lm": iters} and coll == {"psum": iters * (4 + 12), "all_gather": 1},
          f"schur_cm_config6: host reads {reads}, collectives {coll}")
    ctx["check_poses"]("schur_cm_config6", solved, (1700, 4, 4))
    check(torch.isfinite(solved.blocks["landmarks"].values).all().item(), "schur_cm_config6: non-finite landmarks")
    del solved
    torch.cuda.empty_cache()
    log(f"phase 49 (solve_schur_cm, configs 5 and 6): {time.perf_counter() - t_phase!r} s")


def precond_phases(ctx):
    """Phases 50 and 51: the preconditioners of slice 14.  Phase 50: config
    6 at full size (phase 20's graph and plan) through ``solve_schur_large``
    with ``precond="cluster"`` (64 cameras a cluster) and ``"stale"``
    (refreshed every 3 linear solves), each under 1.001 x
    ``venice_full_conv``, CG iterations beside ``jacobi``'s, the pair
    tables' host seconds, the factor's time, ``slot_reduce`` held at the
    pair plans.  Phase 51: sphere2500 (config 3's graph and options)
    through ``solve_ell(precond="two_level")`` and ``solve_bcsr`` in three
    (spmv, precond_group) settings, each under the sphere2500 gate, LM and
    CG iterations beside the ``bj`` route's, ``ell_matvec`` held at the
    ``EllPattern``'s shape and ``slot_reduce`` at the BCSR and coarse
    plans."""
    import torch

    from pyslam_tpu_torch.solver import bcsr, cuda_ops, schur_large
    from pyslam_tpu_torch.solver.lm import Options

    drive, gate, report, standin, dev = (ctx[k] for k in ("drive", "gate", "report", "standin", "dev"))
    if ctx["want"](50):
        # ---- phase 50: cluster and stale-S preconditioners on config 6 -------
        t_phase = time.perf_counter()
        c6 = ctx["config6"]
        g_6, plan_6, common6 = c6["g_6"], c6["plan_6"], c6["common6"]
        opts6 = Options(method="lm", max_iters=10)
        _, parts = schur_large._linearize(plan_6, plan_6.poses, plan_6.lms)
        Hll_inv, _, D, _ = schur_large._reduce(parts, 1e-4, "lm")  # the first linear solve's, at lambda_init
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for precond, kw in (("cluster", dict(cluster_size=64)), ("stale", dict(stale_refresh=3))):
            path = f"{precond}64_config6" if precond == "cluster" else "stale_config6"
            t0 = time.perf_counter()
            if precond == "cluster":
                pairs = plan_6.cpairs = schur_large.build_cluster_pairs(plan_6, 64, 4)
                plan_6.cpairs_G = 64
                build_factor = lambda: schur_large._cluster_precond(pairs, 64, parts, Hll_inv, D)  # noqa: E731
            else:
                pairs = plan_6.pairs = schur_large.build_dense_pairs(plan_6, 4)
                build_factor = lambda: schur_large._stale_factor(pairs, parts, Hll_inv, D)  # noqa: E731
            torch.cuda.synchronize()
            t_pairs = time.perf_counter() - t0
            factor_ms = host_ms(build_factor, reps=3)
            schur_large.solve_schur_large(g_6, Options(method="lm", max_iters=1), plan=plan_6, precond=precond,
                                          **kw, **common6)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            schur_large.reset_cg_iterations()

            def run(precond=precond, kw=kw):
                solved, chi2, hist = schur_large.solve_schur_large(g_6, opts6, plan=plan_6, precond=precond, **kw,
                                                                   **common6)
                torch.cuda.synchronize()
                return solved, chi2, hist

            t0 = time.perf_counter()
            (solved, chi2, hist), launches, reads = drive(path, run, ("slot_reduce",))
            wall = time.perf_counter() - t0
            cg, peak = schur_large.cg_iterations(), torch.cuda.max_memory_allocated()
            log(f"solve {path} f32 (config 6, n_chunks 128, PCG 1e-4 / 12, LM 10): wall {wall!r} s (jacobi "
                f"{c6['wall6']!r} s), LM iterations {len(cg)} (jacobi {c6['iters6']}), accepted {len(hist) - 1}, chi2 "
                f"{hist!r} (jacobi {c6['chi2_6']!r}); CG iterations per linear solve {cg} (jacobi {c6['cg6']}); pair "
                f"table: {pairs.P} pairs into {len(pairs.block_i)} blocks, built in {t_pairs!r} host s; the factor "
                f"{factor_ms!r} host ms a build; host reads {reads}, launches {launches}, peak memory {peak} B")
            gate(f"config6 venice_full_conv, precond={precond}", chi2, 1.001, standin["venice_full_conv"]["chi2"])
            check(reads["pcg"] == 0, f"{path}: host reads {reads}")
            ctx["check_poses"](path, solved, (1700, 4, 4))
            del solved
            # slot_reduce at the pair plan: every pair product, half of D (and
            # the padded cameras' unit blocks), the couplings, into the blocks
            seg = pairs.by_block
            E = len(seg.perm)
            contrib = torch.randn((E, 36), generator=gen, device=dev)
            log(f"{path} pair blocks: contributions {tuple(contrib.shape)} into {seg.n_slots} destinations")
            check_kernel("slot_reduce", *slot_fns(seg.longest),
                         [contrib, seg.perm, seg.offsets, seg.n_slots], report, f"{precond}_pairs_ms",
                         flop=contrib.numel(), library=index_add_library(contrib, seg.perm, seg.offsets, seg.n_slots),
                         calls=5)
            del contrib
        plan_6.pairs = plan_6.cpairs = None
        del parts, Hll_inv, D
        torch.cuda.empty_cache()
        log(f"phase 50 (cluster and stale on config 6): {time.perf_counter() - t_phase!r} s")

    if ctx["want"](51):
        # ---- phase 51: two-level and BCSR on sphere2500 -----------------------
        t_phase = time.perf_counter()
        graph = ctx["sphere"]
        opts = Options(method="lm", max_iters=30, min_cost_decrease=0.999)
        pcg = dict(pcg_rtol=3e-6, pcg_max_iters=120)
        bcsr.solve_ell(graph, opts, **pcg)
        cuda_ops.reset_launches()
        _, info_bj = bcsr.solve_ell(graph, opts, **pcg)
        bj_cg = cuda_ops.pcg_iterations()
        log(f"sphere2500 bj route (the reference beside): LM iterations {info_bj.iterations}, chi2 "
            f"{info_bj.chi2.item()!r}, CG iterations {bj_cg} ({bj_cg / max(info_bj.iterations, 1)!r} a linear solve)")
        runs = [("two_level_sphere2500", lambda: bcsr.solve_ell(graph, opts, precond="two_level", **pcg),
                 ("ell_matvec", "slot_reduce", "ell_assemble"))]
        t0 = time.perf_counter()
        pattern = bcsr.build_pattern(graph)
        t_pattern = time.perf_counter() - t0
        for (spmv, group), path in BCSR_PATHS.items():
            runs.append((path, lambda spmv=spmv, group=group: bcsr.solve_bcsr(graph, opts, pattern=pattern, spmv=spmv,
                                                                               precond_group=group, **pcg),
                         ("ell_matvec", "slot_reduce") if spmv == "ell" else ("slot_reduce",)))
        for path, run, kernels in runs:
            run()  # warm-up
            torch.cuda.synchronize()
            schur_large.reset_cg_iterations()
            t0 = time.perf_counter()
            (solved, info), launches, reads = drive(path, run, kernels)
            chi2 = info.chi2.item()
            wall = time.perf_counter() - t0
            cg = schur_large.cg_iterations()
            log(f"solve {path} f32: wall {1e3 * wall!r} ms, LM iterations {info.iterations} (bj {info_bj.iterations}), "
                f"status {info.status}, CG iterations per linear solve {cg} (bj {bj_cg} in all), host reads {reads}, "
                f"launches {launches}")
            gate(path, chi2, 1.001, ctx["chi2_ref"])
            check(reads == {"pcg": 0, "lm": info.iterations} and launches["ell_pcg"] == 0,
                  f"{path}: host reads {reads}, launches {launches}")
            if "ell_matvec" in kernels:
                check(launches["ell_matvec"] == 120 * len(cg), f"{path}: {launches['ell_matvec']} ell_matvec launches "
                      f"for {len(cg)} linear solves")
            ctx["check_poses"](path, solved, (N_POSES, 4, 4))
        log(f"build_pattern at sphere2500: {t_pattern!r} host s")

        # the kernels at this slice's sphere2500 shapes: ell_matvec over the
        # EllPattern expansion of the damped BCSR store; slot_reduce at the
        # BCSR plans (the assembly's blocks and gradient rows, the product's
        # two passes) and the coarse plans (A_c, r_c), on seeded rows
        H, _, _ = bcsr.assemble_bcsr(graph, pattern)
        ell = bcsr.build_ell(pattern)
        He_e = bcsr.ell_blocks(bcsr.damp_blocks(H, pattern, 1e-4), ell)
        cols_e = bcsr._ell_tables(ell, dev).cols
        x = ctx["x_sphere"]
        bsr = bsr_matrix(He_e, ell)
        log(f"ell_matvec EllPattern shape: nb {ell.nb}, K {ell.K}, d {ell.d}")
        check_kernel("ell_matvec", cuda_ops.ell_matvec, cuda_ops.ell_matvec_plain, [He_e, cols_e, x], report,
                     "bcsr_ms", flop=2 * ell.nb * ell.K * 36, library=lambda: (bsr @ x[:, None])[:, 0])
        dp = bcsr.bcsr_device_plan(pattern, dev)
        coarse = bcsr._coarse_plan(graph, bcsr.build_ell_direct(graph), 128, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for label, seg, width, key in (("BCSR assembly blocks", dp.to_slot, 36, "bcsr_ms"),
                                       ("BCSR gradient rows", dp.to_pose, 6, "bcsr_ms"),
                                       ("BCSR product by row", dp.by_row, 6, "bcsr_ms"),
                                       ("BCSR product by column", dp.by_col, 6, "bcsr_ms"),
                                       ("coarse A_c", coarse.to_coarse, 36, "coarse_ms"),
                                       ("coarse r_c", coarse.by_group, 6, "coarse_ms")):
            contrib = torch.randn((len(seg.perm), width), generator=gen, device=dev)
            log(f"sphere2500 {label}: contributions {tuple(contrib.shape)} into {seg.n_slots} destinations")
            check_kernel("slot_reduce", *slot_fns(seg.longest),
                         [contrib, seg.perm, seg.offsets, seg.n_slots], report, key, flop=contrib.numel(),
                         library=index_add_library(contrib, seg.perm, seg.offsets, seg.n_slots))
        log(f"phase 51 (two-level and BCSR on sphere2500): {time.perf_counter() - t_phase!r} s")


def m3500_data():
    """Bench config 2's graph: ``se2_manhattan(3500, seed=1)`` through the g2o
    writer and reader, as ``bench/run.py`` makes it."""
    import tempfile

    from pyslam_tpu_torch.io import g2o, synth

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m3500.g2o")
        g2o.write_g2o(path, synth.se2_manhattan(n_poses=3500, seed=1))
        return g2o.read_g2o(path)


def vio_inputs(n_keyframes=400):
    """(ImuData, T_prior) of ``examples/vio.py``'s trajectory: a circle at 2
    m/s, a biased, noisy 200 Hz IMU, 2 keyframes a second, pose priors of 2
    mm / 2 mrad drawn from seed 1."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.lie import se3

    d = synth.imu_circle(n_keyframes=n_keyframes, kf_dt=0.5, imu_rate=200, gyro_noise=1.7e-4 * np.sqrt(200),
                         accel_noise=2e-3 * np.sqrt(200), b_gyro=np.array([0.002, -0.001, 0.003]),
                         b_accel=np.array([0.05, -0.03, 0.02]), seed=0)
    rng = np.random.default_rng(1)
    T_prior = np.stack([se3.exp(torch.from_numpy(rng.normal(size=6) * 2e-3)).numpy() @ d.T_gt[i]
                        for i in range(n_keyframes)])
    return d, T_prior


def euroc_round_trip(d, folder):
    """Write the sequence as EuRoC files (``imu0`` and the ground truth),
    read them back with one time origin and segment the IMU stream at the
    keyframe times: (t_kf, T_b_w, v, ImuData with per-interval lists)."""
    import numpy as np

    from pyslam_tpu_torch.io import euroc, synth

    n_int, K = d.dts.shape
    t = np.arange(n_int * K) * d.dts[0, 0]
    t_kf = np.arange(d.T_gt.shape[0]) * (K * d.dts[0, 0])
    imu_path, gt_path = os.path.join(folder, "imu0.csv"), os.path.join(folder, "gt.csv")
    euroc.write_imu(imu_path, t, d.omega.reshape(-1, 3), d.accel.reshape(-1, 3))
    euroc.write_groundtruth(gt_path, t_kf, d.T_gt, d.v_gt, b_gyro=d.b_gyro, b_accel=d.b_accel)
    origin = euroc.first_timestamp_ns(imu_path)
    t2, w2, a2 = euroc.read_imu(imu_path, origin_ns=origin)
    t_kf2, T2, v2, _, _ = euroc.read_groundtruth(gt_path, origin_ns=origin)
    segs = euroc.segment_imu(t2, w2, a2, t_kf2)
    data = synth.ImuData(T2, v2, d.b_gyro, d.b_accel, [s[0] for s in segs], [s[1] for s in segs],
                         [s[2] for s in segs], d.gravity)
    return t_kf2, data


def dense_slot_reduce(label, g, report, key):
    """``slot_reduce`` against its plain version at every group of the
    dense assembly of ``g`` (``check_kernel``), timed in f32 under
    ``key``."""
    import torch

    from pyslam_tpu_torch.solver import assemble, cuda_ops

    d_plan = assemble.dense_plan(g)
    h_parts, g_parts, _ = assemble.dense_contributions(g, hessian=True)
    groups = [(grp, h_parts) for grp in d_plan.h_groups] + [(grp, g_parts) for grp in d_plan.g_groups]
    for grp, parts in groups:
        contrib = torch.cat(parts[grp.shape]).float().contiguous()
        log(f"{label} dense group {grp.shape}: contributions {tuple(contrib.shape)} into {grp.n_slots} destinations")
        check_kernel("slot_reduce", *slot_fns(grp.longest),
                     [contrib, grp.perm, grp.offsets, grp.n_slots], report, key, flop=contrib.numel(),
                     library=index_add_library(contrib, grp.perm, grp.offsets, grp.n_slots))


def robust_init_vio_phases(ctx):
    """Phases 28 to 31: initialization, GNC, switchable loop closures and VIO
    at full size, each held to the JAX reference's numbers (``REF_*``), with
    a small f64 cross-check of the card's path against the CPU path.
    ``ctx`` carries what ``main`` built: the device, ``drive``, ``gate``,
    the kernels report, the reference costs, sphere2500's and config 2's
    data."""
    import tempfile

    import numpy as np
    import torch

    from pyslam_tpu_torch import imu
    from pyslam_tpu_torch.graph import build, initialize
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import bcsr, cuda_ops, route_auto, solve_gnc
    from pyslam_tpu_torch.solver.lm import Options, solve

    dev, drive, gate, report = (ctx[k] for k in ("dev", "drive", "gate", "report"))
    datasets = {"sphere2500": ctx["sphere_data"], "m3500": ctx["m3500"]}
    opts3 = Options(method="lm", max_iters=30, min_cost_decrease=0.999)
    opts2 = Options(method="gn", max_iters=30, min_cost_decrease=0.999)

    def rel_gap(x, ref):
        return abs(x - ref) / abs(ref)

    # ---- phase 28: initialization -------------------------------------------
    # Each init of sphere2500 and of config 2's graph (f32 on the card), its
    # chi2 against the reference's, then the cell's usual solve from it:
    # solve_ell with sphere2500's options, GN as in config 2.
    t_phase = time.perf_counter()
    iters = {}
    for name, data in datasets.items():
        for init in ("odometry", "spanning_tree", "chordal"):
            t0 = time.perf_counter()
            if init == "chordal":  # its stage solves: ELL PCG (rotations), dense (translations)
                g, launches, _ = drive(f"init_chordal_{name}", lambda: build.pose_graph(data, init="chordal"),
                                       ("slot_reduce", "ell_pcg"))
            else:
                g, launches = build.pose_graph(data, init=init), None
            torch.cuda.synchronize()
            t_init = time.perf_counter() - t0
            chi2_0 = g.chi2().item()
            ref = REF_INIT_CHI2[name, init]
            released = REF_INIT_CHI2.get((name, f"{init}_as_released"))
            log(f"init {init} {name}: {1e3 * t_init!r} ms, chi2 {chi2_0!r} (reference {ref!r}, relative gap "
                f"{rel_gap(chi2_0, ref)!r}{'' if released is None else f'; as released {released!r}'}), "
                f"stage launches {launches}")
            check(rel_gap(chi2_0, ref) <= 1e-3, f"init {init} {name}: chi2 {chi2_0} is not within 1e-3 of {ref}")
            if name == "sphere2500":
                run, kernels = (lambda g=g: bcsr.solve_ell(g, opts3, pcg_rtol=3e-6, pcg_max_iters=120)), (
                    "ell_assemble", "ell_pcg")
                factor, gref = 1.001, ctx["chi2_ref"]
            else:
                run, kernels = (lambda g=g: solve(g, opts2)), ("slot_reduce",)
                factor, gref = STANDIN_GATE, ctx["standin"]["se2_manhattan_3500"]["chi2"]
            t0 = time.perf_counter()
            (solved, info), launches, reads = drive(f"{name}_from_{init}", run, kernels)
            chi2 = info.chi2.item()
            iters[name, init] = info.iterations
            log(f"solve {name} from init={init} f32: wall {1e3 * (time.perf_counter() - t0)!r} ms, LM iterations "
                f"{info.iterations} (from odometry {iters[name, 'odometry']}), status {info.status}, chi2 {chi2!r}, "
                f"launches {launches}, host reads {reads}")
            gate(f"{name} from init={init}", chi2, factor, gref)
            check(torch.isfinite(solved.blocks["poses"].values).all().item(), f"{name} from {init}: non-finite poses")

    # ell_pcg and slot_reduce at the chordal rotation stages (9-dof blocks of
    # sphere2500, 4-dof of config 2's graph): the first linear system of the
    # stage's GN step (no damping), its general ELL assembly
    for name, data in datasets.items():
        d = data.dim
        n = data.T_gt.shape[0]
        R_meas = np.asarray(data.T_meas, np.float64)[:, :d, :d]
        g_rot = initialize._rotation_graph(data.edges_i, data.edges_j, R_meas, n, 0, np.eye(d), torch.float32, dev)
        plan = bcsr.build_ell_direct(g_rot)
        dplan = bcsr.ell_device_plan(plan, dev)
        check(bcsr.ell_assemble_batches(g_rot) is None, "chordal_rot must take the general ELL assembly")
        h_contrib, g_contrib, _ = bcsr.ell_contributions(g_rot, plan)
        for contrib, perm, offsets, n_slots, longest in (
                (h_contrib, dplan.h_perm, dplan.h_offsets, plan.nb * plan.K, dplan.h_longest),
                (g_contrib, dplan.g_perm, dplan.g_offsets, plan.nb, dplan.g_longest)):
            check_kernel("slot_reduce", *slot_fns(longest),
                         [contrib, perm, offsets, n_slots], report, f"chordal_{name}_ms", flop=contrib.numel(),
                         library=index_add_library(contrib, perm, offsets, n_slots))
        He, g_vec, _ = bcsr.assemble_ell(g_rot, dplan)
        bsr = bsr_matrix(He, plan)
        log(f"chordal rotation stage {name}: nb {plan.nb} K {plan.K} d {plan.d}, He {tuple(He.shape)} "
            f"({tensor_bytes(He)} B)")
        check_pcg(He, dplan.cols, g_vec, 1e-6, 250, report, label=f"chordal rotation stage {name}",
                  key=f"chordal_{name}_ms", library=lambda bsr=bsr, g_vec=g_vec: (bsr @ g_vec[:, None])[:, 0])
        del h_contrib, g_contrib, He, bsr

    # f64 cross-check, CPU path against the card's: chordal_init, then LM
    small = synth.se3_sphere(n_poses=120, seed=2)
    T0 = {w: initialize.chordal_init(small.edges_i, small.edges_j, small.T_meas, 120, device=w) for w in ("cpu", "cuda")}
    diff = np.abs(T0["cpu"] - T0["cuda"]).max()
    log(f"f64 se3_sphere(120) chordal_init: CPU against card, max pose difference {diff!r}")
    check(diff <= 1e-8, "chordal_init: the CPU and CUDA paths differ")
    res = {w: solve(build.pose_graph(small, dtype=torch.float64, init="chordal", device=w),
                    Options(method="lm", max_iters=40))[::-1] for w in ("cpu", "cuda")}
    cross_check("se3_sphere(120) from init=chordal lm", res)
    log(f"phase 28 (initialization): {time.perf_counter() - t_phase!r} s")

    # ---- phase 29: GNC on sphere2500 with 100 wrong loop closures ----------
    t_phase = time.perf_counter()
    data29, planted = synth.with_outliers(datasets["sphere2500"], 100, magnitude=2.0, seed=1)
    g29 = build.pose_graph(data29)
    check(route_auto(g29) == "ell", f"gnc: route {route_auto(g29)}")
    plans = []
    build_ell_direct = bcsr.build_ell_direct
    bcsr.build_ell_direct = lambda *a, **kw: plans.append(1) or build_ell_direct(*a, **kw)
    try:
        t0 = time.perf_counter()
        (s29, i29), launches, reads = drive("gnc_sphere2500", lambda: solve_gnc(g29, Options(method="lm")),
                                            ("ell_assemble", "ell_pcg"))
        wall = time.perf_counter() - t0
    finally:
        bcsr.build_ell_direct = build_ell_direct
    mask = i29.inlier_masks[0]
    E = mask.size
    ref_mask = np.ones(E, bool)
    ref_mask[REF_GNC["rejected"]] = False
    planted_idx = np.nonzero(planted)[0]
    n_diff = int((mask != ref_mask).sum())
    log(f"gnc sphere2500 + 100 outliers f32 ({E} edges): wall {wall!r} s, outer iterations {i29.outer_iters} "
        f"(reference {REF_GNC['outer_iters']}), inner LM iterations {reads['lm']}, CG iterations "
        f"{cuda_ops.pcg_iterations()}, ELL plans built {len(plans)}, launches {launches}, host reads {reads}; "
        f"rejected {int((~mask).sum())} (reference {len(REF_GNC['rejected'])}), planted rejected "
        f"{int((~mask[planted_idx]).sum())} of 100, mask differs from the reference's on {n_diff} edges; chi2 "
        f"{i29.chi2!r} (reference {REF_GNC['chi2']!r}, gap {rel_gap(i29.chi2, REF_GNC['chi2'])!r})")
    check(np.array_equal(mask[planted_idx], ref_mask[planted_idx]), "gnc: not the reference's planted rejects")
    check(n_diff <= 0.005 * E, f"gnc: the inlier mask differs from the reference's on {n_diff} edges")
    check(rel_gap(i29.chi2, REF_GNC["chi2"]) <= 1e-3, f"gnc: chi2 {i29.chi2} not within 1e-3 of the reference")
    check(len(plans) == i29.outer_iters + 1, f"gnc: {len(plans)} ELL plans for {i29.outer_iters + 1} inner solves")
    small, _ = synth.with_outliers(synth.se3_sphere(n_poses=60, n_loops=8, seed=6), 4, seed=1)
    out = {w: solve_gnc(build.pose_graph(small, dtype=torch.float64, device=w),
                        Options(method="lm", max_iters=30, min_cost_decrease=0.999)) for w in ("cpu", "cuda")}
    (_, i_c), (_, i_g) = out["cpu"], out["cuda"]
    log(f"f64 se3_sphere(60) + 4 outliers solve_gnc: cpu outer {i_c.outer_iters} chi2 {i_c.chi2!r}; cuda outer "
        f"{i_g.outer_iters} chi2 {i_g.chi2!r}")
    check(i_c.outer_iters == i_g.outer_iters and np.array_equal(i_c.inlier_masks[0], i_g.inlier_masks[0])
          and rel_gap(i_g.chi2, i_c.chi2) <= 1e-8, "solve_gnc: the CPU and CUDA paths differ")
    log(f"phase 29 (GNC): {time.perf_counter() - t_phase!r} s")

    # ---- phase 30: switchable loop closures, M3500 + 100 wrong loops --------
    # The reference's gates hold the f64 solve: the objective is not convex in
    # the 508 switches, and the f32 solve takes another LM path to another
    # local minimum (2 more true loops switched off and a chi2 1.1% higher,
    # measured on an H100); it runs beside, every planted switch below 0.5.
    t_phase = time.perf_counter()
    poisoned, _ = synth.with_outliers(datasets["m3500"], 100, seed=2)
    for dtype in (torch.float32, torch.float64):
        tname = str(dtype).split(".")[-1]
        g30 = build.switchable_pose_graph(poisoned, xi=5.0, dtype=dtype)
        check(route_auto(g30) == "dense", f"switchable: route {route_auto(g30)}")
        if dtype is torch.float32:
            dense_slot_reduce("switchable m3500", g30, report, "switch_m3500_ms")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (s30, i30), launches, reads = drive(f"switchable_m3500_{tname}",
                                            lambda: solve(g30, Options(method="lm", max_iters=60)), ("slot_reduce",))
        wall = time.perf_counter() - t0
        sw = s30.blocks["switches"].values[:, 0].cpu().numpy()
        below = np.nonzero(sw < 0.5)[0]
        chi2 = i30.chi2.item()
        log(f"switchable m3500 + 100 outliers {tname} (D = {g30.total_dof}, {sw.size} switches): wall {wall!r} s, LM "
            f"iterations {i30.iterations} (reference {REF_SWITCH['iterations']}), status {i30.status}, chi2 {chi2!r} "
            f"(reference {REF_SWITCH['chi2']!r}, gap {rel_gap(chi2, REF_SWITCH['chi2'])!r}), switches below 0.5 "
            f"{below.size} (reference {len(REF_SWITCH['below_half'])}; differ on "
            f"{len(set(below.tolist()) ^ set(REF_SWITCH['below_half']))}), planted max {sw[-100:].max()!r}, true "
            f"loops min {sw[:-100].min()!r}, launches {launches}, host reads {reads}, peak memory "
            f"{torch.cuda.max_memory_allocated()} B")
        check(np.isfinite(chi2) and sw[-100:].max() < 0.5, f"switchable {tname}: a planted switch stayed on")
        if dtype is torch.float64:
            check(set(below.tolist()) == set(REF_SWITCH["below_half"]),
                  "switchable: not the reference's switches below 0.5")
            check(rel_gap(chi2, REF_SWITCH["chi2"]) <= 1e-3, f"switchable: chi2 {chi2} not within 1e-3 of the reference")
    small, _ = synth.with_outliers(synth.se2_loop(n_poses=60, n_loops=8, seed=0), 3, seed=1)
    res = {w: solve(build.switchable_pose_graph(small, xi=5.0, dtype=torch.float64, device=w),
                    Options(method="lm", max_iters=60))[::-1] for w in ("cpu", "cuda")}
    cross_check("se2_loop(60) + 3 outliers switchable lm", res)
    sw_c, sw_g = (res[w][1].blocks["switches"].values.cpu() for w in ("cpu", "cuda"))
    check((sw_c - sw_g).abs().max().item() <= 1e-6, "switchable: the CPU and CUDA switches differ")
    del g30, s30
    log(f"phase 30 (switchable): {time.perf_counter() - t_phase!r} s")

    # ---- phase 31: VIO from EuRoC files --------------------------------------
    t_phase = time.perf_counter()
    d31, T_prior = vio_inputs()
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        t_kf, data31 = euroc_round_trip(d31, td)
        t_io = time.perf_counter() - t0
    lengths = sorted({len(x) for x in data31.dts})
    n = data31.T_gt.shape[0]
    w, a, dts = (torch.from_numpy(x).to(dev) for x in imu._padded_intervals(data31.omega, data31.accel, data31.dts))
    z = torch.zeros((n - 1, 3), dtype=torch.float64, device=dev)

    def preint():
        return imu._preintegrate_batched(w, a, dts, z, z, 1.7e-4, 2e-3)

    t_pre = host_ms(preint)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pim = preint()
        torch.cuda.synchronize()
    n_kernels = sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    t_prof = time.perf_counter() - t0
    t0 = time.perf_counter()
    g31 = imu.vio_graph(data31, T_prior, np.diag([1 / 2e-3] * 6), T_init=T_prior, v_init=np.zeros((n, 3)),
                        b_init=np.zeros((n, 6)))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check(route_auto(g31) == "dense" and g31.blocks["poses"].values.dtype == torch.float64, "vio: route or dtype")
    chi2_0 = g31.chi2().item()
    dense_slot_reduce("vio400", g31, report, "vio400_ms")
    t0 = time.perf_counter()
    (s31, i31), launches, reads = drive("vio400", lambda: solve(g31, Options(method="lm", max_iters=60)),
                                        ("slot_reduce",))
    wall = time.perf_counter() - t0
    chi2 = i31.chi2.item()
    v_err = np.abs(s31.blocks["vels"].values.cpu().numpy() - d31.v_gt).max()
    bg_err = np.abs(s31.blocks["biases"].values.cpu().numpy().mean(0)[:3] - d31.b_gyro).max()
    log(f"vio400 f64 ({n - 1} intervals of {lengths} samples, D = {g31.total_dof}): EuRoC write + read + segment "
        f"{t_io!r} s; preintegration {t_pre!r} ms (median of 5), {n_kernels} kernels (counted under torch.profiler, "
        f"{t_prof!r} s); vio_graph {1e3 * t_build!r} ms; "
        f"chi2 {chi2_0!r} -> {chi2!r} (reference {REF_VIO['chi2_init']!r} -> {REF_VIO['chi2']!r}, gap "
        f"{rel_gap(chi2, REF_VIO['chi2'])!r}), LM iterations {i31.iterations} (reference {REF_VIO['iterations']}), "
        f"status {i31.status}, wall {1e3 * wall!r} ms, velocity error {v_err!r}, gyro bias error {bg_err!r}, "
        f"launches {launches}, host reads {reads}")
    check(rel_gap(chi2, REF_VIO["chi2"]) <= 1e-8 and i31.iterations == REF_VIO["iterations"],
          "vio: chi2 or LM iterations differ from the reference's")
    check(v_err < 0.05 and bg_err < 1.5e-3, f"vio: velocity error {v_err} or gyro bias error {bg_err}")
    worst = 0.0
    for i in np.linspace(0, n - 2, 8).astype(int):
        one = imu.preintegrate(data31.omega[i], data31.accel[i], data31.dts[i], np.zeros(3), np.zeros(3), device=dev)
        for name in one._fields:
            ref, out = getattr(one, name), getattr(pim, name)[i]
            err = (out - ref).abs().max().item()
            check(err <= 1e-12 * max(ref.abs().max().item(), 1e-300), f"vio: interval {i} {name} differs by {err}")
            worst = max(worst, err)
    log(f"vio400: batched preintegration against the per-interval one on the card, 8 intervals: max abs diff {worst!r}")
    d12, T12 = vio_inputs(12)
    res = {w_: solve(imu.vio_graph(d12, T12, np.diag([1 / 2e-3] * 6), T_init=T12, v_init=np.zeros((12, 3)),
                                   b_init=np.zeros((12, 6)), device=w_), Options(method="lm", max_iters=60))[::-1]
           for w_ in ("cpu", "cuda")}
    cross_check("imu_circle(12) vio lm", res)
    log(f"phase 31 (VIO): {time.perf_counter() - t_phase!r} s")


def sync_count(fn):
    """(fn(), the synchronizing CUDA calls it made): every read to the host
    and every blocking copy, as ``torch.cuda.set_sync_debug_mode("warn")``
    reports them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def no_sync(fn):
    """fn() with every synchronizing CUDA call an error."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def spread(times):
    """'median / p90' of a list of seconds, in ms."""
    import numpy as np

    return f"median {1e3 * float(np.median(times))!r} ms, p90 {1e3 * float(np.percentile(times, 90))!r} ms"


def frame_clock(sm):
    """Wrap ``sm.update`` to stamp each return: the frame times are the
    gaps between stamps (adds, marginalizations and the update, ending in
    its read of the poses)."""
    stamps = [time.perf_counter()]
    update = sm.update

    def stamped():
        out = update()
        stamps.append(time.perf_counter())
        return out

    sm.update = stamped
    return stamps


# each online phase's function and the phase numbers that run it (phase 41
# reads the smoother of phase 35)
ONLINE_PHASES = (("vio_window_phase", (32,)), ("fixed_lag_phases", (33, 34)), ("incremental_phase", (35, 41)),
                 ("sqrt_phase", (36,)), ("online_cross_checks", (32, 33, 34, 35, 36)))


def online_phases(ctx):
    """Phases 32 to 36: the online and marginalized estimators at full size
    (the sliding-window VIO, the fixed-lag smoothers on sphere2500 and on
    bench config 8, the incremental smoother on config 2's stream, the
    square-root Schur route of ``solve_auto``), each held to the JAX
    reference's numbers (``REF_*`` and ``chip_smoke_refs.npz``), with
    ``slot_reduce`` at the square-root path's shape and small f64
    cross-checks of the card against the CPU path.  ``ctx`` carries the
    device, ``drive``, the kernels report, config 2's data and ``want``,
    the phase selection."""
    for name, numbers in ONLINE_PHASES:
        if ctx["want"](*numbers):
            globals()[name](ctx)


def vio_window_phase(ctx):
    import dataclasses as dc

    import numpy as np
    import torch

    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.lie import se3
    from pyslam_tpu_torch.testing import vio_sliding_window

    dev, drive = ctx["dev"], ctx["drive"]
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))

    # ---- phase 32: the sliding-window VIO of examples/vio_sliding_window.py --
    # phase 31's trajectory, window 5, LM 25 a keyframe, f64; every interval
    # preintegrated once up front (batched).  The default run streams the
    # first VIO_PREFIX keyframes (each held to the reference's, which are
    # those of its full run: the window sees no later keyframe); a run that
    # selects phase 32 streams all 400.
    t_phase = time.perf_counter()
    d_full, T_full = vio_inputs()
    n_kf = len(T_full) if ctx["selected"] else VIO_PREFIX + 1
    d32 = dc.replace(d_full, T_gt=d_full.T_gt[:n_kf], v_gt=d_full.v_gt[:n_kf], omega=d_full.omega[:n_kf - 1],
                     accel=d_full.accel[:n_kf - 1], dts=d_full.dts[:n_kf - 1])
    T32 = T_full[:n_kf]
    ref_errs, ref_chi2 = refs["p32_errs"][:n_kf - 1], refs["p32_chi2"][:n_kf - 1]
    ref_iters = list(refs["p32_iterations"][:n_kf - 1])
    ref_bg_err = float(refs["p32_bg_errs"][n_kf - 2])  # the reference's at the stream's last keyframe
    stamps = []
    t0 = time.perf_counter()
    (errs, chi2s, iters, g32), launches, reads = drive(
        "vio_window", lambda: vio_sliding_window(d32, T32, device=dev,
                                                 on_keyframe=lambda *a: stamps.append(time.perf_counter())),
        ("slot_reduce",))
    wall = time.perf_counter() - t0
    err_gap = float(np.abs(np.asarray(errs) - ref_errs).max())
    chi2_gap = float(np.max(np.abs(np.asarray(chi2s) - ref_chi2) / np.maximum(ref_chi2, 1e-3)))
    b_est = g32.blocks["biases"].values.mean(0).cpu().numpy()
    bg_err = float(np.abs(b_est[:3] - d32.b_gyro).max())
    log(f"vio window f64 ({len(errs)} keyframes, window 5): wall {wall!r} s (preintegration and the first keyframe "
        f"{stamps[0] - t0!r} s), per keyframe {spread(np.diff(stamps))}; LM iterations {sum(iters)}, LM host reads "
        f"{reads['lm']}, launches {launches}; newest-pose error max {max(errs)!r} (from the 6th {max(errs[5:])!r}; "
        f"reference {REF_VIO_WINDOW['max_err']!r} / {REF_VIO_WINDOW['max_err_from_6th']!r}), gap to the reference "
        f"{err_gap!r}, chi2 relative gap {chi2_gap!r}, LM iterations equal {list(iters) == ref_iters}"
        f", gyro bias error {bg_err!r} (reference at {n_kf - 1} keyframes {ref_bg_err!r})")
    check(len(errs) == n_kf - 1 and err_gap <= 1e-9, f"vio window: newest-pose errors {err_gap} from the reference's")
    check(chi2_gap <= 1e-9 and list(iters) == ref_iters, "vio window: chi2 or LM iterations")
    # the example's bounds: the first holds; the reference itself exceeds the
    # other two on this trajectory, which the port may not exceed further
    # (the bias against the reference's after the same keyframes: at 399
    # REF_VIO_WINDOW's)
    check(max(errs) < 1e-2, "vio window: newest-pose error above the example's 1e-2")
    check(max(errs[5:]) <= REF_VIO_WINDOW["max_err_from_6th"] + 1e-9 and bg_err <= ref_bg_err + 1e-9,
          "vio window: worse than the reference against the example's bounds")
    (_, syncs) = sync_count(lambda: vio_sliding_window(
        dc.replace(d32, T_gt=d32.T_gt[:12], v_gt=d32.v_gt[:12], omega=d32.omega[:11], accel=d32.accel[:11],
                   dts=d32.dts[:11]), T32[:12], device=dev))
    log(f"vio window: synchronizing calls over the first 11 keyframes (reads, blocking copies) {syncs}")
    # the example's own data (16 keyframes, gyro bias only) and its three asserts
    b_gyro = np.array([0.002, -0.001, 0.003])
    d16 = synth.imu_circle(n_keyframes=16, kf_dt=0.5, imu_rate=200, gyro_noise=1.7e-4 * np.sqrt(200),
                           accel_noise=2e-3 * np.sqrt(200), b_gyro=b_gyro, seed=0)
    rng = np.random.default_rng(1)
    T16 = np.stack([se3.exp(torch.from_numpy(rng.normal(size=6) * 2e-3)).numpy() @ d16.T_gt[i] for i in range(16)])
    e16, _, _, g16 = vio_sliding_window(d16, T16, device=dev)
    b16 = float(np.abs(g16.blocks["biases"].values.mean(0).cpu().numpy()[:3] - b_gyro).max())
    log(f"vio window, the example's 16 keyframes: newest-pose error max {max(e16)!r}, from the 6th "
        f"{max(e16[5:])!r}, gyro bias error {b16!r}")
    check(max(e16) < 1e-2 and max(e16[5:]) < 5e-3 and b16 < 1.5e-3, "vio window: the example's asserts")
    log(f"phase 32 (sliding-window VIO): {time.perf_counter() - t_phase!r} s")


def fixed_lag_phases(ctx):
    import numpy as np
    import torch

    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import FixedLagLandmarkSmoother, FixedLagSmoother
    from pyslam_tpu_torch.testing import drive_fixed_lag, drive_fixed_lag_landmarks, window_trajectory

    dev, drive = ctx["dev"], ctx["drive"]
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))
    f32, f64 = torch.float32, torch.float64
    # ---- phase 33: FixedLagSmoother over sphere2500 -------------------------
    t_phase = time.perf_counter()
    data33 = synth.se3_sphere(n_poses=2500, seed=0)
    ref33 = refs["p33_poses"]
    # f32: rounding grows along the stream; the largest pose entry of the
    # reference's f32 run is 0.037 from its f64 run, the port's 0.046 on the
    # CPU and 0.108 on an H100 (the window's LU and sums in other orders)
    f32_tol33 = 0.25
    for dtype in (f64, f32):
        tname = str(dtype).split(".")[-1]
        sm = FixedLagSmoother(window=100, kind="se3", gn_iters=3, anchor_sqrt_info=1e4, dtype=dtype, device=dev)
        stamps = frame_clock(sm)
        t0 = time.perf_counter()
        (left, last), launches, _ = drive(f"fixed_lag_sphere2500_{tname}", lambda: drive_fixed_lag(sm, data33, 2500),
                                              ("slot_reduce",))
        wall = time.perf_counter() - t0
        gap = np.abs(window_trajectory(left, last, 2500) - ref33).max(axis=(1, 2))
        log(f"fixed-lag sphere2500 {tname} (window 100, 3 GN a frame, {len(data33.edges_i)} edges): wall {wall!r} s, "
            f"per frame {spread(np.diff(stamps[1:]))}, dense plans {sm.plans_built}, launches {launches}; gap to the "
            f"reference max {float(gap.max())!r} (first 500 poses {float(gap[:500].max())!r}, last window "
            f"{float(gap[-100:].max())!r})")
        check(np.isfinite(gap).all(), f"fixed-lag sphere2500 {tname}: non-finite poses")
        if dtype is f32:
            log(f"fixed-lag sphere2500 float32: the reference's own f32 gap {REF_FIXED_LAG['sphere2500_f32_gap']!r}, "
                f"tolerance {f32_tol33}")
        check(gap.max() <= (1e-8 if dtype is f64 else f32_tol33),
              f"fixed-lag sphere2500 {tname}: {gap.max()} from the reference")
        state = sm._device_plan()
        no_sync(lambda: sm._gn_steps(*state))  # a GN step makes no host read and no transfer
        _, syncs = sync_count(lambda: (sm.add_odometry(np.eye(4), np.eye(6)), sm.update()))
        log(f"fixed-lag sphere2500 {tname}: the GN steps ran with synchronizing calls as errors; one more frame "
            f"(a marginalization, a new factor, the update) made {syncs} synchronizing calls")
    log(f"phase 33 (fixed-lag sphere2500): {time.perf_counter() - t_phase!r} s")

    # ---- phase 34: FixedLagLandmarkSmoother over bench config 8's graph ----
    # The window's marginalization chain amplifies rounding: on the CPU a
    # relative change of 1e-15 in one observation moves the reference's f64
    # run by 2.1e-6 by its last poses, and the port's CPU run ends 3.2e-6
    # from it.  So the first 300 poses are held to 1e-8 and all to 1e-4; f32
    # ends metres away in either package (the reference's 12.1), and is held
    # to twice the reference's own gap.
    t_phase = time.perf_counter()
    data34 = synth.landmark_slam_2d(n_poses=800, n_landmarks=250, max_range=10.0, obs_type="bearing_range",
                                    odo_rot_std=0.005, seed=0)
    for dtype in (f64, f32):
        tname = str(dtype).split(".")[-1]
        sm = FixedLagLandmarkSmoother(window=20, lm_slots=64, obs_kind="bearing_range_se2", kind="se2", gn_iters=3,
                                      dtype=dtype, device=dev)
        stamps = frame_clock(sm)
        t0 = time.perf_counter()
        (left, last, ret), launches, _ = drive(f"fixed_lag_lm_config8_{tname}",
                                                   lambda: drive_fixed_lag_landmarks(sm, data34, 800), ("slot_reduce",))
        wall = time.perf_counter() - t0
        gap = np.abs(window_trajectory(left, last, 800) - refs["p34_poses"]).max(axis=(1, 2))
        ret_ids = [i for i, _ in ret]
        ret_gap = float(np.abs(np.stack([v for _, v in ret]) - refs["p34_retired_values"]).max())
        live = sm.landmarks()
        lm_gap = float(np.abs(np.stack([live[i] for i in sorted(live)]) - refs["p34_live_landmarks"]).max())
        log(f"fixed-lag landmarks config 8 {tname} (window 20, 64 slots, 3 GN a frame): wall {wall!r} s, per frame "
            f"{spread(np.diff(stamps[1:]))}, dense plans {sm.plans_built}, retired {len(ret_ids)} (reference "
            f"{len(REF_FIXED_LAG['config8_retired'])}, same order {ret_ids == REF_FIXED_LAG['config8_retired']}), "
            f"launches {launches}; gap to the reference: poses max {float(gap.max())!r} (first 300 "
            f"{float(gap[:300].max())!r}), "
            f"retired landmarks {ret_gap!r}, live landmarks {lm_gap!r}")
        check(ret_ids == REF_FIXED_LAG["config8_retired"] and sorted(live) == REF_FIXED_LAG["config8_live"],
              f"fixed-lag landmarks {tname}: not the reference's retirements")
        check(np.isfinite(gap).all(), f"fixed-lag landmarks {tname}: non-finite poses")
        if dtype is f64:
            check(gap[:300].max() <= 1e-8 and max(gap.max(), ret_gap, lm_gap) <= 1e-4,
                  f"fixed-lag landmarks f64: {gap.max()} from the reference")
        else:
            check(gap.max() <= 2 * REF_FIXED_LAG["config8_f32_gap"], f"fixed-lag landmarks f32: {gap.max()}")
        state = sm._device_state()
        no_sync(lambda: sm._gn_steps(*state))
    log(f"phase 34 (fixed-lag landmarks, config 8): {time.perf_counter() - t_phase!r} s")


def incremental_phase(ctx):
    import numpy as np
    import torch

    from pyslam_tpu_torch.solver import IncrementalSmoother
    from pyslam_tpu_torch.testing import drive_incremental

    dev, drive = ctx["dev"], ctx["drive"]
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))
    # ---- phase 35: IncrementalSmoother over config 2's stream ---------------
    t_phase = time.perf_counter()
    sm = IncrementalSmoother(kind="se2", device=dev)
    upd_times = []
    update = sm.update

    def timed_update():
        t0 = time.perf_counter()
        out = update()
        upd_times.append(time.perf_counter() - t0)
        return out

    sm.update = timed_update

    def stream():
        ups = drive_incremental(sm, ctx["m3500"], every=250)
        ctx["p35_before"] = copy.deepcopy(sm)  # phase 41's smoother before the retirement
        t0 = time.perf_counter()
        sm.marginalize_oldest(keep_last=500)
        t_marg = time.perf_counter() - t0
        _, info = sm.update()
        return ups + [(info.chi2.item(), info.iterations)], t_marg

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (ups, t_marg), launches, reads = drive("incremental_m3500", stream, ("slot_reduce",))
    wall = time.perf_counter() - t0
    chi2_gap = max(abs(c - r) / r for (c, _), r in zip(ups, REF_INCREMENTAL["chi2"]))
    pose_gap = float(np.abs(sm.poses() - refs["p35_poses"]).max())
    log(f"incremental m3500 f64 ({len(ups)} updates, capacity {sm.cap} after retirement): wall {wall!r} s, per update "
        f"{spread(upd_times)} (largest {1e3 * max(upd_times)!r} ms), marginalize_oldest(500) {1e3 * t_marg!r} ms; "
        f"LM iterations {[i for _, i in ups]} (reference {REF_INCREMENTAL['iterations']}), compiles {sm.compiles} "
        f"(reference {REF_INCREMENTAL['compiles']}), chi2 relative gap {chi2_gap!r}, final poses gap {pose_gap!r}; "
        f"LM host reads {reads['lm']}, launches {launches}, peak memory {torch.cuda.max_memory_allocated()} B")
    check([i for _, i in ups] == REF_INCREMENTAL["iterations"] and sm.compiles == REF_INCREMENTAL["compiles"]
          and sm.n == REF_INCREMENTAL["n_final"], "incremental: LM iterations, compiles or live poses differ")
    check(chi2_gap <= 1e-8 and pose_gap <= 1e-8 * max(1.0, float(np.abs(refs["p35_poses"]).max())),
          f"incremental: chi2 {chi2_gap} or poses {pose_gap} from the reference")
    ctx["p35_after"] = sm
    log(f"phase 35 (incremental, config 2's stream): {time.perf_counter() - t_phase!r} s")


def sqrt_phase(ctx):
    import numpy as np
    import torch

    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import bal
    from pyslam_tpu_torch.solver import cuda_ops, route_auto, schur_sqrt, solve_auto, solve_schur
    from pyslam_tpu_torch.solver.lm import Options

    dev, drive, report = ctx["dev"], ctx["drive"], ctx["report"]
    f32, f64 = torch.float32, torch.float64
    # ---- phase 36: the schur_sqrt route on a Ladybug-49-size mono BA --------
    t_phase = time.perf_counter()
    bal36 = bal.perturbed(bal.synthetic_bal(49, 7000, seed=0, cam_cluster=0.05))
    g64 = build.bal_graph(bal36, dtype=f64, device=dev)
    g32 = build.bal_graph(bal36, dtype=f32, device=dev)
    check(route_auto(g32) == "schur_sqrt", f"sqrt: route {route_auto(g32)}")
    opts = Options(method="lm", max_iters=50)
    t0 = time.perf_counter()
    (_, i64), launches64, reads64 = drive("sqrt_ladybug_float64", lambda: schur_sqrt.solve_schur_sqrt(g64, opts),
                                            ("slot_reduce",))
    wall64 = time.perf_counter() - t0
    c64 = i64.chi2.item()
    t0 = time.perf_counter()
    (_, i32), launches32, _ = drive("sqrt_ladybug_solve_auto", lambda: solve_auto(g32, opts), ("slot_reduce",))
    wall32 = time.perf_counter() - t0
    _, idense = solve_schur(g32, opts, mode="dense")
    gap_sqrt, gap_dense = abs(i32.chi2.item() - c64) / c64, abs(idense.chi2.item() - c64) / c64
    log(f"sqrt ladybug-49 mono ({g64.batches[0].n} observations): f64 solve_schur_sqrt wall {1e3 * wall64!r} ms, LM "
        f"{i64.iterations} (reference {REF_SQRT['iterations']}), chi2 {c64!r} (reference {REF_SQRT['chi2']!r}, gap "
        f"{abs(c64 - REF_SQRT['chi2']) / REF_SQRT['chi2']!r}), launches {launches64}, host reads {reads64}; f32 "
        f"solve_auto (schur_sqrt) wall {1e3 * wall32!r} ms, LM {i32.iterations}, launches {launches32}; f32 gap to f64: "
        f"square root {gap_sqrt!r} (reference's {REF_SQRT['gap_sqrt_f32']!r}), solve_schur dense {gap_dense!r} "
        f"(reference's {REF_SQRT['gap_dense_f32']!r})")
    check(i64.iterations == REF_SQRT["iterations"] and abs(c64 - REF_SQRT["chi2"]) <= 1e-8 * REF_SQRT["chi2"],
          "sqrt f64: not the reference's solve")
    check(np.isfinite(gap_sqrt) and gap_sqrt <= 1e-4, f"sqrt f32: {gap_sqrt} from the f64 solve")
    plan = schur_sqrt.build_sqrt_plan(g32)
    perm, offsets = (torch.from_numpy(a).to(dev) for a in plan.pair_plan)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for width, (pm, of, n_slots), longest in (
            (plan.dp * plan.dp, (perm, offsets, len(plan.pair_blocks)), cuda_ops.slot_longest(plan.pair_plan[1])),
            (plan.dp, (*(torch.from_numpy(a).to(dev) for a in plan.grad_plan), plan.C),
             cuda_ops.slot_longest(plan.grad_plan[1]))):
        contrib = torch.randn((len(pm), width), generator=gen, device=dev)
        log(f"sqrt ladybug-49 slot_reduce: {tuple(contrib.shape)} into {n_slots}")
        kernel, plain = slot_fns(longest)
        check_kernel("slot_reduce", kernel, plain, [contrib, pm, of, n_slots],
                     report, "sqrt_ladybug_ms", flop=contrib.numel(), library=index_add_library(contrib, pm, of, n_slots))
        a, b = kernel(contrib, pm, of, n_slots), kernel(contrib, pm, of, n_slots)
        check(torch.equal(a, b), "slot_reduce at the square-root shape: two runs differ")
    log(f"phase 36 (schur_sqrt): {time.perf_counter() - t_phase!r} s")


def online_cross_checks(ctx):
    import numpy as np
    import torch

    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import bal, synth
    from pyslam_tpu_torch.solver import FixedLagLandmarkSmoother, FixedLagSmoother, schur_sqrt
    from pyslam_tpu_torch.solver.lm import Options
    from pyslam_tpu_torch.testing import drive_fixed_lag, drive_fixed_lag_landmarks, window_trajectory

    f64 = torch.float64
    where = {"cpu": "cpu", "cuda": ctx["dev"]}
    # f64 cross-checks, the CPU path against the card's
    small = synth.se2_loop(n_poses=30, n_loops=8, seed=1)
    out = {}
    for w in where:
        sm = FixedLagSmoother(window=6, kind="se2", gn_iters=3, dtype=f64, device=where[w])
        out[w] = window_trajectory(*drive_fixed_lag(sm, small, 30), 30)
    diff = float(np.abs(out["cpu"] - out["cuda"]).max())
    lm = synth.landmark_slam_2d(n_poses=25, n_landmarks=12, obs_type="bearing_range", max_range=10.0, seed=3)
    outl = {}
    for w in where:
        sm = FixedLagLandmarkSmoother(window=6, lm_slots=8, obs_kind="bearing_range_se2", kind="se2", gn_iters=3,
                                      dtype=f64, device=where[w], obs_capacity=64)
        left, last, ret = drive_fixed_lag_landmarks(sm, lm, 25)
        outl[w] = (window_trajectory(left, last, 25), [i for i, _ in ret])
    diffl = float(np.abs(outl["cpu"][0] - outl["cuda"][0]).max())
    res = {w: schur_sqrt.solve_schur_sqrt(build.bal_graph(bal.perturbed(bal.synthetic_bal(6, 50, seed=0)),
                                                          dtype=f64, device=where[w]), Options(method="lm", max_iters=25))
           for w in where}
    log(f"f64 cross-checks, CPU against card: fixed-lag se2_loop(30) {diff!r}, fixed-lag landmarks {diffl!r} (same "
        f"retirements {outl['cpu'][1] == outl['cuda'][1]}), schur_sqrt chi2 {res['cpu'][1].chi2.item()!r} / "
        f"{res['cuda'][1].chi2.item()!r}")
    check(diff <= 1e-9 and diffl <= 1e-9 and outl["cpu"][1] == outl["cuda"][1], "fixed-lag: CPU and card differ")
    cross_check("bal(6, 50) schur_sqrt lm", {w: res[w][::-1] for w in res})


def rel_gap(out, ref):
    """max |out - ref| over max |ref|, both tensors or arrays."""
    import numpy as np
    import torch

    out, ref = (t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t) for t in (out, ref))
    check(out.shape == ref.shape, f"shapes {out.shape} and {ref.shape}")
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300))


def check_pcg_columns(He_cov, He_d64, He_d32, cols, g_d32, report):
    """The multi-column ``ell_pcg`` against ``ell_pcg_plain`` at sphere2500's
    shapes, m = 1, 12 and the plan's maximum, on Marquardt-damped systems
    (lambda 1e-4): in f64 at the covariance query's estimate (rtol 1e-10,
    cap 2000, and rtol 0, cap 60), in f32 the first LM solve's (rtol 3e-6,
    cap 120, as ``check_pcg``).  The columns: unit vectors at poses spread
    over the graph (covariance columns; the anchor's stops after one
    iteration), a zero column (stops before its first), a random one, and
    in f32 the gradient.  One launch per block, no host read, two runs the
    same bits.  Then the undamped query system He_cov itself, f64, rtol
    1e-10, cap 2000, at the plan's maximum rounded down to whole poses (the
    block phase 37 launches) and at m = 1, against the plain version, and
    timed against m launches of the single-column kernel, the plain version
    and ``torch.cholesky_solve`` of the dense H against the same columns.

    Tolerances.  Iterations: equal to the plain version's where a column
    runs to its cap (all columns at rtol 0).  A column that stops on its
    tolerance is held to the stop test itself, not to the plain version's
    count: the test compares two norms whose dot products sum in other
    orders, and a residual that creeps along the threshold crosses it some
    iterations apart (on an H100, damped: 347 against 348; undamped: 419
    against 498 for one column, x 1.6e-9 apart).  So in f64 such a column
    must stop before its cap with a true residual at or below rtol
    norm(b_j), as the plain version's must.  x: within 1e-8 of each
    column's largest entry in f64.  f32: where a column stops on its
    tolerance, as ``check_pcg`` (x within 1e-4, the true residual within 1%
    of the plain version's); where it runs to the cap, x within 1e-3 and
    the true residual within 10% (a unit column excites the slowest modes,
    and 120 dependent f32 steps in two summation orders part: on an H100
    1.7e-4 in x with true residuals 0.0372 and 0.0371, and 3.3e-5 in x with
    0.00949 and 0.00916).  True residuals are evaluated in f64."""
    import math

    import torch

    from pyslam_tpu_torch.solver import cuda_ops, linear
    from pyslam_tpu_torch.solver.bcsr import sym_block_inv

    nb, K, d, _ = He_cov.shape
    n = nb * d
    dev = He_cov.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    r = report.setdefault("ell_pcg", {})

    def columns(m, dtype, first=None):
        B = torch.zeros((n, m), dtype=dtype, device=dev)
        for j in range(m):
            B[((j * 389) % nb) * d + j % d, j] = 1.0
        if m >= 3:
            B[:, 1] = 0.0
            B[:, 2] = torch.randn(n, generator=gen, device=dev, dtype=dtype)
        if first is not None:
            B[:, 0] = first
        return B

    def residual(A, B, X):
        """Each column's true relative residual, in f64 (a zero column: 0)."""
        r = torch.linalg.norm(B.double() - cuda_ops._ell_matvec_columns(A.double(), cols, X.double()), dim=0)
        return r / torch.clamp(torch.linalg.norm(B.double(), dim=0), min=1e-300)

    def compare(label, A, B, res, ref, rtol, cap_it):
        """Hold the kernel's block ``res`` to the plain version's ``ref``
        column by column, by the rules above; the largest x error."""
        f64 = A.dtype is torch.float64
        its, its_ref = res.iterations.tolist(), ref.iterations.tolist()
        scale = torch.clamp(ref.x.double().abs().amax(0), min=1e-300)
        errs = ((res.x - ref.x).double().abs().amax(0) / scale).tolist()
        res_k, res_p = residual(A, B, res.x).tolist(), residual(A, B, ref.x).tolist()
        log(f"ell_pcg columns sphere2500 {label}: iterations {its} (plain {its_ref}), column errors max "
            f"{max(errs)!r}, true residuals max {max(res_k)!r} (plain {max(res_p)!r})")
        check(torch.isfinite(res.x).all().item(), f"ell_pcg columns {label}: non-finite x")
        for j in range(B.shape[1]):
            if its_ref[j] == cap_it or rtol == 0.0:
                ok = its[j] == its_ref[j]
            elif f64:
                ok = its[j] < cap_it and res_k[j] <= rtol
            else:
                ok = res_k[j] <= 1.01 * res_p[j] + 1e-30
            if f64:
                ok = ok and errs[j] <= 1e-8
            else:
                x_tol = 1e-3 if its_ref[j] == cap_it else 1e-4
                ok = ok and errs[j] <= x_tol and (its_ref[j] != cap_it or res_k[j] <= 1.1 * res_p[j] + 1e-30)
            check(ok, f"ell_pcg columns {label} column {j}: iterations {its[j]} (plain {its_ref[j]}), "
                      f"error {errs[j]}, true residual {res_k[j]} (plain {res_p[j]})")
        return max(errs)

    for dtype, He, rtol, cap_it in ((torch.float64, He_d64, 1e-10, 2000), (torch.float64, He_d64, 0.0, 60),
                                    (torch.float32, He_d32, 3e-6, 120)):
        tname = str(dtype).split(".")[-1]
        A = He.to(dtype).contiguous()
        Minv = sym_block_inv(A[:, 0]).contiguous()
        plan = cuda_ops.ell_pcg_plan(nb, K, d, dtype, dev)
        cap = plan["max_columns"]
        for m in sorted({1, min(12, cap), cap}):
            B = columns(m, dtype, g_d32 if dtype is torch.float32 else None)
            cuda_ops.reset_launches()
            linear.reset_host_reads()
            res = cuda_ops.ell_pcg(A, cols, Minv, B, rtol, cap_it)
            torch.cuda.synchronize()
            launches, reads = cuda_ops.LAUNCHES["ell_pcg"], linear.HOST_READS["pcg"]
            again = cuda_ops.ell_pcg(A, cols, Minv, B, rtol, cap_it)
            ref = cuda_ops.ell_pcg_plain(A, cols, Minv, B, rtol, cap_it)
            label = f"{tname} damped rtol {rtol} cap {cap_it} m={m}"
            log(f"ell_pcg columns sphere2500 {label} (plan max {cap}, resident rows {res.resident_rows}): "
                f"launches {launches}, host reads {reads}")
            check(launches == 1 and reads == 0, f"ell_pcg columns {label}: {launches} launches, {reads} reads")
            check(torch.equal(res.x, again.x) and torch.equal(res.iterations, again.iterations),
                  f"ell_pcg columns {label}: two runs differ")
            if m >= 3:
                check(res.iterations[1].item() == 0 and not res.x[:, 1].any(),
                      f"ell_pcg columns {label}: the zero column ran")
            err = compare(label, A, B, res, ref, rtol, cap_it)
            r[f"block_max_rel_err_{tname}"] = max(r.get(f"block_max_rel_err_{tname}", 0.0), err)

    # the undamped query system in f64, the covariance's type: checked
    # against the plain version and timed, one launch of the plan's maximum
    # (whole poses) against its columns one launch each, the plain version,
    # the dense Cholesky factor's solve; m = 1 beside it
    from pyslam_tpu_torch.solver.assemble import unit_diag_where_dead_

    A = He_cov.contiguous()
    Minv = sym_block_inv(A[:, 0]).contiguous()
    cap = cuda_ops.ell_pcg_plan(nb, K, d, torch.float64, dev)["max_columns"]

    # the dense H from the ELL store: row r's K blocks at its columns (a
    # padding slot is a zero block at the row itself)
    H = torch.zeros((n, n), dtype=torch.float64, device=dev)
    rows = torch.arange(nb, device=dev)
    for k in range(K):
        H.view(nb, d, nb, d)[rows, :, cols[:, k].long(), :] += A[:, k]
    unit_diag_where_dead_(H)
    L, info = torch.linalg.cholesky_ex(H)
    check(int(info) == 0, "the dense H of the covariance system is not positive definite")
    del H
    chunk = cap - cap % d if cap >= d else cap
    per_it = 2 * nb * (K + 1) * d * d + 12 * nb * d
    for key, m in (("block_ms", chunk), ("block1_ms", 1)):
        B = columns(m, torch.float64)
        res = cuda_ops.ell_pcg(A, cols, Minv, B, 1e-10, 2000)
        ref = cuda_ops.ell_pcg_plain(A, cols, Minv, B, 1e-10, 2000)
        err = compare(f"float64 undamped rtol 1e-10 cap 2000 m={m}", A, B, res, ref, 1e-10, 2000)
        r["block_max_rel_err_float64"] = max(r.get("block_max_rel_err_float64", 0.0), err)
        its = res.iterations.tolist()
        singles = [B[:, j].contiguous() for j in range(m)]
        times = dict(
            ms=median_ms(lambda: cuda_ops.ell_pcg(A, cols, Minv, B, 1e-10, 2000), (), calls=5),
            single_ms=median_ms(lambda: [cuda_ops.ell_pcg(A, cols, Minv, b, 1e-10, 2000) for b in singles], (),
                                calls=3),
            plain_ms=median_ms(lambda: cuda_ops.ell_pcg_plain(A, cols, Minv, B, 1e-10, 2000), (), calls=3),
            library_ms=median_ms(lambda: torch.cholesky_solve(B, L), (), calls=5),
        )
        add_times(report, "ell_pcg", key, times, tensor_bytes(A, cols, Minv, B, res.x), sum(its) * per_it)
        log(f"ell_pcg columns sphere2500 f64 {key[:-3]}: {m} columns, iterations {its}, "
            f"{1e3 * times['ms'] / max(max(its), 1)!r} us per iteration of the launch")
    r["block_columns"] = chunk
    r["block_launches_per_query"] = math.ceil(256 * d / chunk)  # phase 37's 256 poses
    del L


def sphere_covariance_phase(ctx):
    """Phase 37: sphere2500's pose marginals at full size, f64, at the main
    path's converged estimate (phase 4's f32 solve): the dense inverse as
    referee, the selected inverse of every pose, PCG columns of 256 poses,
    the odometry cross blocks, log det H; then at the ground truth, the
    estimate the JAX reference holds too, against its numbers.  The
    multi-column ``ell_pcg`` is checked and timed first at these shapes."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.graph.core import VariableBlock
    from pyslam_tpu_torch.solver import assemble, bcsr, covariance, cuda_ops, solve_ell, sparse_chol
    from pyslam_tpu_torch.solver.lm import Options

    dev, drive, report = ctx["dev"], ctx["drive"], ctx["report"]
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))
    f64 = torch.float64
    t_phase = time.perf_counter()
    data = ctx["sphere_data"]
    g64 = build.pose_graph(data, dtype=f64)
    solved = ctx.get("sphere_solved")
    if solved is None:  # phase 4 did not run: its solve
        solved, _ = solve_ell(ctx["sphere"], Options(method="lm", max_iters=30, min_cost_decrease=0.999),
                              pcg_rtol=3e-6, pcg_max_iters=120)
    pb = g64.blocks["poses"]

    def at(values):
        return g64.with_values({"poses": VariableBlock(pb.kind, values, pb.const_mask)})

    g37 = at(solved.blocks["poses"].values.to(f64))
    nb, d = pb.n, pb.dof

    # the kernel: the covariance system (undamped, f64) and the first LM
    # solve's (damped, f32)
    eplan = bcsr.build_ell_direct(g37)
    dplan = bcsr.ell_device_plan(eplan, dev)
    He_cov, _, _ = bcsr.assemble_ell(g37, dplan)
    He32, g32, _ = bcsr.assemble_ell(ctx["sphere"], dplan)

    def damped(He):
        out = He.clone()
        out[:, 0] += Options().lambda_init * torch.diag_embed(
            torch.clamp(torch.diagonal(He[:, 0], dim1=-2, dim2=-1), min=1e-12))
        return out

    check_pcg_columns(He_cov, damped(He_cov), damped(He32), dplan.cols, g32, report)
    del He32, g32
    t_kernel = time.perf_counter() - t_phase

    def timed(path, run, kernels):
        t0 = time.perf_counter()
        out, launches, reads = drive(path, run, kernels)
        return out, time.perf_counter() - t0, launches, reads

    full, t_full, l_full, _ = timed("cov_sphere2500_full", lambda: covariance.full_covariance(g37), ("slot_reduce",))
    F = full.view(nb, d, nb, d)
    full_diag = F.diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    split = {}

    def selinv_all():
        """``marginal_covariances_direct`` of every pose, step by step."""
        t0 = time.perf_counter()
        plan = sparse_chol.build_chol_plan(g37)
        split["plan_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        _, _, factors = covariance._plan_and_factors(g37, None, plan, 32)
        torch.cuda.synchronize()
        split["assemble_factor_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        out = covariance.marginal_covariances_direct(g37, plan=plan, factors=factors)
        torch.cuda.synchronize()
        split["sweep_ms"] = 1e3 * (time.perf_counter() - t0)
        return out, plan, factors

    (sel, plan, factors), t_sel, l_sel, _ = timed("cov_sphere2500_selinv", selinv_all, ("ell_assemble",))
    gap_sel = rel_gap(sel, full_diag)
    idx = np.linspace(0, nb - 1, 256).astype(np.int64)
    pcg, t_pcg, l_pcg, r_pcg = timed(
        "cov_sphere2500_pcg",
        lambda: covariance.marginal_covariances(g37, indices=idx, pcg_rtol=1e-10, pcg_max_iters=2000),
        ("ell_assemble", "ell_pcg"))
    cg = cuda_ops.pcg_iterations()
    gap_pcg = rel_gap(pcg, full_diag[torch.as_tensor(idx, device=dev)])
    pairs = [(i, i + 1) for i in range(nb - 1)]
    (_, blocks), t_pairs, l_pairs, _ = timed(
        "cov_sphere2500_pairs", lambda: covariance.covariance_blocks_direct(g37, pairs, plan=plan), ("ell_assemble",))
    ii = torch.arange(nb - 1, device=dev)
    gap_pairs = rel_gap(blocks, F[ii, :, ii + 1, :])
    del full, F, full_diag
    logdet = sparse_chol.factor_logdet(plan, factors).item()
    H, _, _ = assemble.assemble_dense(g37)
    assemble.unit_diag_where_dead_(H)
    sign, ref_logdet = torch.linalg.slogdet(H)
    del H
    gap_logdet = abs(logdet - ref_logdet.item()) / abs(ref_logdet.item())
    log(f"sphere2500 covariance f64 (2,500 poses, D = {nb * d}): full_covariance {1e3 * t_full!r} ms, launches "
        f"{l_full}; marginal_covariances_direct (all poses, selected inverse) {1e3 * t_sel!r} ms, gap to the dense "
        f"inverse {gap_sel!r}, split {split}, launches {l_sel}; marginal_covariances (256 poses, PCG 1e-10) {1e3 * t_pcg!r} ms, CG "
        f"iterations {cg} over {256 * d} columns, gap {gap_pcg!r}, launches {l_pcg}, host reads {r_pcg}; "
        f"covariance_blocks_direct ({nb - 1} odometry pairs) {1e3 * t_pairs!r} ms, gap {gap_pairs!r}; factor_logdet "
        f"{logdet!r}, slogdet {ref_logdet.item()!r} (sign {sign.item()!r}), gap {gap_logdet!r}; kernel check and "
        f"times {t_kernel!r} s")
    check(gap_sel <= 1e-9 and gap_pairs <= 1e-9, f"sphere2500: the selected inverse is {gap_sel} / {gap_pairs} from "
          "the dense inverse")
    check(gap_pcg <= 1e-6, f"sphere2500: the PCG columns are {gap_pcg} from the dense inverse")
    check(r_pcg["pcg"] == 0 and l_pcg["ell_pcg"] == report["ell_pcg"]["block_launches_per_query"],
          f"sphere2500 PCG columns: launches {l_pcg}, host reads {r_pcg}")
    check(sign.item() == 1.0 and gap_logdet <= 1e-12, f"sphere2500: log det {logdet} against {ref_logdet.item()}")
    report.setdefault("covariance", {})["sphere2500"] = dict(
        full_ms=1e3 * t_full, selinv_all_ms=1e3 * t_sel, pcg_256_ms=1e3 * t_pcg, cg_iterations=cg,
        pairs_ms=1e3 * t_pairs, gap_selinv=gap_sel, gap_pcg=gap_pcg)

    # the JAX reference's numbers, at the ground truth
    gt = at(torch.as_tensor(data.T_gt, dtype=f64, device=dev))
    _, plan_t, f_t = covariance._plan_and_factors(gt, None, None, 32)
    marg_t = covariance.marginal_covariances_direct(gt, plan=plan_t, factors=f_t)
    pair_t = covariance.covariance_blocks_direct(gt, [tuple(p) for p in refs["p37_pairs"]], plan=plan_t,
                                                 factors=f_t)[1]
    logdet_t = sparse_chol.factor_logdet(plan_t, f_t).item()
    gaps = (rel_gap(marg_t[torch.as_tensor(refs["p37_idx"], device=dev)], refs["p37_marg"]),
            rel_gap(pair_t, refs["p37_pair_blocks"]), abs(logdet_t - float(refs["p37_logdet"])) / abs(logdet_t))
    log(f"sphere2500 at the ground truth against the JAX reference: 64 marginals {gaps[0]!r}, 16 odometry blocks "
        f"{gaps[1]!r}, log det {gaps[2]!r}")
    check(gaps[0] <= 1e-9 and gaps[1] <= 1e-9 and gaps[2] <= 1e-12, f"sphere2500: {gaps} from the JAX reference")
    log(f"phase 37 (sphere2500 covariance): {time.perf_counter() - t_phase!r} s")


def m3500_covariance_phase(ctx):
    """Phase 38: ``bench/covariance_bench.py``'s case in f64: se2_manhattan
    (3,500 poses, seed 1) solved by ``solve_auto`` GN 25, then the plan,
    the factorization, every marginal by the selected inverse and 16 by
    column solves (held to the sweep); at the ground truth, those 16 against
    the JAX reference."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.graph.core import VariableBlock
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import bcsr, covariance, route_auto, solve_auto, sparse_chol
    from pyslam_tpu_torch.solver.lm import Options

    dev, drive = ctx["dev"], ctx["drive"]
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))
    f64 = torch.float64
    t_phase = time.perf_counter()
    data = synth.se2_manhattan(n_poses=3500, seed=1)
    g = build.pose_graph(data, dtype=f64)
    t0 = time.perf_counter()
    (solved, info), l_solve, _ = drive("cov_m3500_solve", lambda: solve_auto(g, Options(method="gn", max_iters=25)),
                                       ("slot_reduce",))
    t_solve = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = sparse_chol.build_chol_plan(solved)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    He, _, _ = bcsr.assemble_ell(solved, bcsr.ell_device_plan(plan.ell, dev))
    factors = sparse_chol._factorize(plan, He)
    torch.cuda.synchronize()
    t_factor = time.perf_counter() - t0
    t0 = time.perf_counter()
    sel, l_sel, _ = drive("cov_m3500_selinv",
                          lambda: covariance.marginal_covariances_direct(solved, plan=plan, factors=factors), ())
    t_sel = time.perf_counter() - t0
    idx = refs["p38_idx"]
    t0 = time.perf_counter()
    cols, l_cols, _ = drive(
        "cov_m3500_columns",
        lambda: covariance.marginal_covariances_direct(solved, indices=idx, plan=plan, factors=factors),
        ("slot_reduce",))
    t_cols = time.perf_counter() - t0
    gap = rel_gap(cols, sel[torch.as_tensor(idx, device=dev)])
    pb = g.blocks["poses"]
    gt = g.with_values({"poses": VariableBlock(pb.kind, torch.as_tensor(data.T_gt, dtype=f64, device=dev),
                                               pb.const_mask)})
    _, plan_t, f_t = covariance._plan_and_factors(gt, None, None, 32)
    gap_ref = rel_gap(covariance.marginal_covariances_direct(gt, indices=idx, plan=plan_t, factors=f_t),
                      refs["p38_marg"])
    logdet_t = sparse_chol.factor_logdet(plan_t, f_t).item()
    gap_logdet = abs(logdet_t - float(refs["p38_logdet"])) / abs(logdet_t)
    log(f"m3500 covariance f64: solve_auto GN (route {route_auto(g)}) {1e3 * t_solve!r} ms, {info.iterations} "
        f"iterations, chi2 {info.chi2.item()!r}; build_chol_plan {1e3 * t_plan!r} ms ({len(plan.waves)} waves), "
        f"assembly and factorization {1e3 * t_factor!r} ms, selected inverse of 3,500 marginals {1e3 * t_sel!r} ms, "
        f"16 column solves {1e3 * t_cols!r} ms (launches {l_cols}), columns against the sweep {gap!r}; at the ground "
        f"truth against the JAX reference {gap_ref!r}, log det {gap_logdet!r}")
    check(gap <= 1e-9, f"m3500: the column solves are {gap} from the selected inverse")
    check(gap_ref <= 1e-9 and gap_logdet <= 1e-12, f"m3500: {gap_ref} / {gap_logdet} from the JAX reference")
    report = ctx["report"].setdefault("covariance", {})
    report["m3500"] = dict(plan_ms=1e3 * t_plan, factor_ms=1e3 * t_factor, selinv_all_ms=1e3 * t_sel,
                           columns_16_ms=1e3 * t_cols)
    log(f"phase 38 (M3500 covariance): {time.perf_counter() - t_phase!r} s")


def ba_covariance_phase(ctx):
    """Phase 39: bundle-adjustment covariances in f64.  Bench config 4's
    graph (49 cameras, 7,000 points) at its converged estimate: every pose
    marginal, 16 landmark marginals, a pose-landmark and a landmark-landmark
    block, by ``pcg`` and by ``sparse``, against the dense inverse on the
    card.  Venice-mini (300 cameras, 60,000 points), whose dense inverse does
    not fit, at its ground truth: 16 camera and 16 point marginals, ``pcg``
    against ``sparse`` and both against the JAX reference."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.graph.core import VariableBlock
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import covariance, solve_schur
    from pyslam_tpu_torch.solver.lm import Options

    dev, drive = ctx["dev"], ctx["drive"]
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))
    f64 = torch.float64
    t_phase = time.perf_counter()
    ba = synth.ba_synthetic(n_cams=49, n_pts=7000, seed=0)
    solved, _ = solve_schur(build.ba_graph(ba, dtype=f64), Options(method="lm", max_iters=25), mode="dense")
    off = solved.offsets()
    D = solved.total_dof
    t0 = time.perf_counter()
    full, l_full, _ = drive("cov_config4_full", lambda: covariance.full_covariance(solved), ("slot_reduce",))
    t_full = time.perf_counter() - t0

    def block(name_a, i, name_b, j):
        da, db = solved.blocks[name_a].dof, solved.blocks[name_b].dof
        a, b = off[name_a] + i * da, off[name_b] + j * db
        return full[a:a + da, b:b + db]

    C, L = solved.blocks["poses"].n, solved.blocks["landmarks"].n
    obs3 = np.flatnonzero(ba.cam_idx == 3)
    l1, l2 = int(ba.pt_idx[obs3[0]]), int(ba.pt_idx[obs3[1]])
    lms = np.linspace(0, L - 1, 16).astype(np.int64)
    ref_pose = torch.stack([block("poses", i, "poses", i) for i in range(C)])
    ref_lm = torch.stack([block("landmarks", i, "landmarks", i) for i in lms])
    ref_pl, ref_ll = block("poses", 3, "landmarks", l1), block("landmarks", l1, "landmarks", l2)
    times, gaps = {}, {}
    for method, tol in (("pcg", 1e-6), ("sparse", 1e-9)):
        kw = dict(method=method, pcg_max_iters=1000)
        t0 = time.perf_counter()
        (pose, lm, pl, ll), launches, reads = drive(f"cov_config4_{method}", lambda: (
            covariance.pose_marginal_covariances(solved, **kw), covariance.landmark_marginal_covariances(solved, lms, **kw),
            covariance.pose_landmark_covariance_block(solved, 3, l1, **kw),
            covariance.landmark_covariance_block(solved, l1, l2, **kw)), ("slot_reduce",))
        times[method] = time.perf_counter() - t0
        gaps[method] = tuple(rel_gap(a, b) for a, b in ((pose, ref_pose), (lm, ref_lm), (pl, ref_pl), (ll, ref_ll)))
        log(f"config4 covariance {method}: {1e3 * times[method]!r} ms, gaps to the dense inverse ({C} poses, 16 "
            f"landmarks, pose-landmark, landmark-landmark) {gaps[method]}, launches {launches}, host reads {reads}")
        check(max(gaps[method]) <= tol, f"config4 {method}: {gaps[method]} from the dense inverse")
    log(f"config4 covariance f64: D = {D}, full_covariance {1e3 * t_full!r} ms (H {8 * D * D} B), launches {l_full}")
    del full

    # Venice-mini at its ground truth
    vm = synth.ba_synthetic(n_cams=300, n_pts=60000, obs_per_pt=6, seed=0)
    g = build.ba_graph(vm, dtype=f64)
    pb, lb = g.blocks["poses"], g.blocks["landmarks"]
    gvm = g.with_values({"poses": VariableBlock(pb.kind, torch.as_tensor(vm.T_gt, dtype=f64, device=dev), pb.const_mask),
                         "landmarks": VariableBlock(lb.kind, torch.as_tensor(vm.pts_gt, dtype=f64, device=dev),
                                                    lb.const_mask)})
    cams, pts = refs["p39_cams"], refs["p39_pts"]
    out = {}
    for method in ("pcg", "sparse"):
        kw = dict(method=method, pcg_max_iters=1000)
        t0 = time.perf_counter()
        out[method], launches, reads = drive(f"cov_venice_{method}", lambda: (
            covariance.pose_marginal_covariances(gvm, indices=cams, **kw),
            covariance.landmark_marginal_covariances(gvm, pts, **kw)), ("slot_reduce",))
        times[f"venice_{method}"] = time.perf_counter() - t0
        log(f"venice-mini covariance {method} (16 cameras, 16 points): {1e3 * times[f'venice_{method}']!r} ms, "
            f"launches {launches}, host reads {reads}")
    (pp, lp), (ps, ls) = out["pcg"], out["sparse"]
    vgaps = dict(pcg_sparse=(rel_gap(pp, ps), rel_gap(lp, ls)),
                 sparse_jax=(rel_gap(ps, refs["p39_pose_marg"]), rel_gap(ls, refs["p39_lm_marg"])),
                 pcg_jax=(rel_gap(pp, refs["p39_pose_marg"]), rel_gap(lp, refs["p39_lm_marg"])))
    log(f"venice-mini covariance f64 at the ground truth ({g.batches[0].n} observations, D = {g.total_dof}, a dense "
        f"inverse {8 * g.total_dof ** 2} B): gaps (poses, points) {vgaps}")
    check(max(vgaps["pcg_sparse"] + vgaps["pcg_jax"]) <= 1e-6 and max(vgaps["sparse_jax"]) <= 1e-9,
          f"venice-mini covariance: {vgaps}")
    ctx["p39_venice"] = dict(graph=gvm, cams=cams, pts=pts, pose=pp, lms=lp)
    ctx["report"].setdefault("covariance", {})["ba"] = dict(
        config4_full_ms=1e3 * t_full, **{f"{k}_ms": 1e3 * v for k, v in times.items()})
    log(f"phase 39 (bundle-adjustment covariance): {time.perf_counter() - t_phase!r} s")


def covariance_phases(ctx):
    """Phases 37 to 39 (39 also for 40, which reads its numbers)."""
    want = ctx["want"]
    if want(37):
        sphere_covariance_phase(ctx)
    if want(38):
        m3500_covariance_phase(ctx)
    if want(39, 40):
        ba_covariance_phase(ctx)


def sharded_marginals_phase(ctx, mesh):
    """Phase 40, on the one-rank NCCL mesh: ``sharded_pose_marginals`` (16
    cameras) and ``sharded_landmark_marginals`` (16 points) of config 5's
    Venice-mini at phase 39's estimate, against phase 39's single-device
    PCG numbers within 1e-6."""
    from pyslam_tpu_torch import dist

    t_phase = time.perf_counter()
    p39 = ctx["p39_venice"]
    dist.reset_collectives()
    t0 = time.perf_counter()
    (pose, lms), launches, reads = ctx["drive"]("cov_venice_sharded", lambda: (
        dist.sharded_pose_marginals(p39["graph"], mesh, p39["cams"], pcg_max_iters=1000),
        dist.sharded_landmark_marginals(p39["graph"], mesh, p39["pts"], pcg_max_iters=1000)), ("slot_reduce",))
    wall = time.perf_counter() - t0
    gaps = (rel_gap(pose, p39["pose"]), rel_gap(lms, p39["lms"]))
    log(f"venice-mini sharded marginals (1 rank, NCCL): {1e3 * wall!r} ms, gaps to the single device (poses, "
        f"points) {gaps}, collectives {dict(dist.COLLECTIVES)}, launches {launches}, host reads {reads}")
    check(max(gaps) <= 1e-6, f"sharded marginals: {gaps} from the single-device ones")
    log(f"phase 40 (sharded marginals): {time.perf_counter() - t_phase!r} s")


def incremental_marginals_phase(ctx):
    """Phase 41: ``IncrementalSmoother.pose_marginals`` in its three
    branches against the JAX reference: phase 35's smoother before and
    after ``marginalize_oldest`` (the direct branch both times: the dense
    prior of a pose graph names only poses), and a small landmark stream
    without (S-solves) and with ``keep_window`` (a prior over poses and
    landmarks: the dense inverse).  The states agree with the reference's to
    1e-8, the marginals are held to 1e-6 of their largest entry."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import IncrementalSmoother
    from pyslam_tpu_torch.solver import covariance
    from pyslam_tpu_torch.solver.lm import Options
    from pyslam_tpu_torch.testing import drive_incremental_landmarks

    dev, drive = ctx["dev"], ctx["drive"]
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))
    t_phase = time.perf_counter()
    called = []
    saved = {name: getattr(covariance, name) for name in
             ("marginal_covariances_direct", "pose_marginal_covariances", "full_covariance")}
    for name, fn in saved.items():
        setattr(covariance, name, lambda *a, _fn=fn, _name=name, **kw: called.append(_name) or _fn(*a, **kw))
    try:
        t0 = time.perf_counter()
        (before, after), launches, _ = drive("incremental_marginals_direct", lambda: (
            ctx["p35_before"].pose_marginals(), ctx["p35_after"].pose_marginals()), ("slot_reduce",))
        wall = time.perf_counter() - t0
        gaps = {"direct_before": rel_gap(before[refs["p41_idx"]], refs["p41_before"]),
                "direct_after": rel_gap(after[refs["p41_idx_after"]], refs["p41_after"])}
        log(f"incremental pose_marginals, phase 35's stream: {before.shape[0]} poses before the retirement, "
            f"{after.shape[0]} after, {1e3 * wall!r} ms for both, launches {launches}")
        data = synth.landmark_slam_2d(n_poses=22, n_landmarks=12, max_range=9.0, obs_type="bearing_range", seed=8)
        for key, keep, path in (("p41_schur", None, "incremental_marginals_schur"),
                                ("p41_dense", 10, "incremental_marginals_dense")):
            sm = IncrementalSmoother(kind="se2", obs_kind="bearing_range_se2", options=Options(method="lm", max_iters=15),
                                     device=dev)
            drive_incremental_landmarks(sm, data, 6, keep)
            t0 = time.perf_counter()
            marg, launches, _ = drive(path, sm.pose_marginals, ("slot_reduce",))
            gaps[key[4:]] = rel_gap(marg, refs[key])
            log(f"incremental pose_marginals, landmark stream (keep_window {keep}): {marg.shape[0]} poses, "
                f"{1e3 * (time.perf_counter() - t0)!r} ms, launches {launches}")
    finally:
        for name, fn in saved.items():
            setattr(covariance, name, fn)
    log(f"incremental pose_marginals: branches {called}, gaps to the JAX reference {gaps}")
    check(called == ["marginal_covariances_direct", "marginal_covariances_direct", "pose_marginal_covariances",
                     "full_covariance"], f"incremental pose_marginals: branches {called}")
    check(max(gaps.values()) <= 1e-6, f"incremental pose_marginals: {gaps} from the JAX reference")
    log(f"phase 41 (incremental marginals): {time.perf_counter() - t_phase!r} s")


def batched_repairs_phase(ctx):
    """Phase 42: ``solve_batched`` on phase 17's fleet (16 se2_loop(100)
    graphs, f64, LM 50) under ``TDistributionLoss()`` (a scale per problem)
    and, with L2, by dogleg: each problem's iterations, stop code and accept
    sequence those of its single solve, chi2 within 1e-10 of it, and within
    1e-8 of the JAX reference's ``solve_batched``."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.losses import TDistributionLoss
    from pyslam_tpu_torch.solver import solve, solve_batched
    from pyslam_tpu_torch.solver.lm import Options

    drive = ctx["drive"]
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))
    t_phase = time.perf_counter()
    loops = [synth.se2_loop(n_poses=100, n_loops=12, seed=s) for s in range(16)]
    for path, loss, method, ref in (("batched_tdist_16", TDistributionLoss(), "lm", refs["p42_chi2_t"]),
                                    ("batched_dogleg_16", None, "dogleg", refs["p42_chi2_dogleg"])):
        fleet = [build.pose_graph(d, loss=loss, dtype=torch.float64) for d in loops]
        opts = Options(method=method, max_iters=50)
        t0 = time.perf_counter()
        (_, chi2, info), launches, reads = drive(path, lambda: solve_batched(fleet, opts, return_info=True),
                                                 ("slot_reduce",))
        wall = time.perf_counter() - t0
        singles = [solve(g, opts)[1] for g in fleet]
        same = all(info.iterations[b] == s.iterations and info.status[b] == s.status
                   and info.accepted[b].tolist() == s.accepted.tolist()
                   and abs(chi2[b].item() - s.chi2.item()) <= 1e-10 * s.chi2.item() for b, s in enumerate(singles))
        gap = float(np.max(np.abs(chi2.cpu().numpy() - ref) / ref))
        log(f"{path}: wall {1e3 * wall!r} ms, LM iterations {info.iterations}, host reads {reads}, launches "
            f"{launches}; every problem its single solve {same}; chi2 gap to the JAX reference {gap!r}")
        check(same and reads == {"pcg": 0, "lm": max(info.iterations)}, f"{path}: problems left their single solves")
        check(gap <= 1e-8, f"{path}: chi2 {gap} from the JAX reference")
    log(f"phase 42 (solve_batched repairs): {time.perf_counter() - t_phase!r} s")


def later_covariance_phases(ctx):
    """Phases 41 and 42."""
    if ctx["want"](41):
        incremental_marginals_phase(ctx)
    if ctx["want"](42):
        batched_repairs_phase(ctx)


def problem_phase(ctx):
    """Phase 43: sphere2500 through the object API, as a user builds it:
    2,500 ``SE3`` parameters, 4,948 ``PoseToPoseResidual`` blocks, pose 0
    constant, ``Problem(Options(method="lm", max_iters=30,
    min_cost_decrease=0.999))`` in f32 on the card's default device, then
    ``problem.solve()``.  The built graph must be ``build.pose_graph``'s
    tensor for tensor, the route ``ell``, chi2 and the ``ell_assemble`` /
    ``ell_pcg`` launches those of ``solve_auto`` on that graph, under the
    sphere2500 gate.  Then ``get_covariance_block`` of two poses (15,000
    dof: the lazy path, PCG columns by ``ell_pcg``), in f32 and on a f64
    Problem at the solved estimate, the f64 blocks held to the selected
    inverse of phase 37 (``covariance_blocks_direct``)."""
    import numpy as np
    import torch

    from pyslam_tpu_torch import Options, PoseToPoseResidual, Problem, SE3
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.solver import covariance, route_auto, solve_auto

    drive, gate = ctx["drive"], ctx["gate"]
    t_phase = time.perf_counter()
    data = ctx["sphere_data"]
    opts = Options(method="lm", max_iters=30, min_cost_decrease=0.999)
    g = build.pose_graph(data, dtype=torch.float32)
    route = route_auto(g)
    (ref_solved, ref_info), ref_launches, _ = drive("problem_reference_solve_auto", lambda: solve_auto(g, opts),
                                                    ("ell_assemble", "ell_pcg"))

    t0 = time.perf_counter()
    names = [f"x{i}" for i in range(len(data.T_init))]
    problem = Problem(opts)
    problem.initialize_params({n: SE3(T) for n, T in zip(names, data.T_init)})
    for i, j, T_meas, S in zip(data.edges_i, data.edges_j, data.T_meas, data.sqrt_info):
        problem.add_residual_block(PoseToPoseResidual(SE3(T_meas), S), [names[i], names[j]])
    problem.set_parameters_constant(names[0])
    t_blocks = time.perf_counter() - t0
    t0 = time.perf_counter()
    built = problem._build()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    (pb,), (gb,) = built.blocks.values(), g.blocks.values()
    (pf,), (gf,) = built.batches, g.batches
    same = (torch.equal(pb.values, gb.values) and torch.equal(pb.const_mask, gb.const_mask) and pf.kind == gf.kind
            and all(torch.equal(a, b) for a, b in zip(pf.indices, gf.indices)) and torch.equal(pf.weight, gf.weight)
            and sorted(pf.data) == sorted(gf.data) and all(torch.equal(pf.data[k], gf.data[k]) for k in gf.data))
    check(problem.device.type == "cuda" and pb.values.device.type == "cuda", "Problem did not build on the card")
    check(same, "problem: the built graph is not build.pose_graph's")
    check(route == "ell" and route_auto(built) == "ell", f"problem: route {route!r}, expected 'ell'")
    t0 = time.perf_counter()
    _, launches, reads = drive("problem_sphere2500", problem.solve, ("ell_assemble", "ell_pcg"))
    t_solve = time.perf_counter() - t0
    info = problem.summary
    chi2 = info.chi2.item()
    log(f"problem sphere2500 f32: residual blocks {t_blocks!r} s, _build {1e3 * t_build!r} ms, solve {1e3 * t_solve!r} "
        f"ms; LM iterations {info.iterations}, chi2 {chi2!r} (solve_auto on the built graph {ref_info.chi2.item()!r}), "
        f"launches {launches} (solve_auto {ref_launches}), host reads {reads}")
    check(chi2 == ref_info.chi2.item() and info.iterations == ref_info.iterations,
          f"problem: chi2 {chi2} in {info.iterations} iterations, solve_auto {ref_info.chi2.item()}")
    check(all(launches[k] == ref_launches[k] for k in ("ell_assemble", "ell_pcg", "slot_reduce")),
          f"problem: launches {launches} against solve_auto's {ref_launches}")
    check(torch.equal(problem.param_dict[names[-1]].mat, ref_solved.blocks["poses"].values[-1]),
          "problem: the written-back pose is not the solved one")
    gate("problem sphere2500", chi2, 1.001, ctx["chi2_ref"])

    # the lazy covariance: in f32 as solved, and on a f64 Problem at the estimate
    i, j = 1000, 1001
    t0 = time.perf_counter()
    (b32_ii, b32_ij), l32, _ = drive("problem_covariance_f32", lambda: (
        problem.get_covariance_block(names[i], names[i]), problem.get_covariance_block(names[i], names[j])),
        ("ell_assemble", "ell_pcg"))
    t_cov32 = time.perf_counter() - t0
    check(problem._covariance is None, "problem: 15,000 dof did not take the lazy covariance")
    p64 = Problem(opts, dtype=torch.float64)
    p64.initialize_params(problem.param_dict)
    p64.residual_blocks = list(problem.residual_blocks)
    p64.set_parameters_constant(names[0])
    t0 = time.perf_counter()
    (b64_ii, b64_ij), l64, _ = drive("problem_covariance_f64", lambda: (
        p64.get_covariance_block(names[i], names[i]), p64.get_covariance_block(names[i], names[j])),
        ("ell_assemble", "ell_pcg"))
    t_cov64 = time.perf_counter() - t0
    t0 = time.perf_counter()
    marg, pair = covariance.covariance_blocks_direct(p64._build(), [(i, j)])
    t_sel = time.perf_counter() - t0
    gaps64 = (rel_gap(b64_ii, marg[i]), rel_gap(b64_ij, pair[0]))
    gaps32 = (rel_gap(b32_ii.double(), marg[i]), rel_gap(b32_ij.double(), pair[0]))
    log(f"problem sphere2500 covariance of poses {i} and {j}: f32 {1e3 * t_cov32!r} ms (launches {l32}), gaps to the "
        f"selected inverse {gaps32!r}; f64 {1e3 * t_cov64!r} ms (launches {l64}), gaps {gaps64!r}; selected inverse "
        f"{1e3 * t_sel!r} ms")
    check(max(gaps64) <= 1e-6, f"problem: the f64 lazy blocks are {gaps64} from the selected inverse")
    check(all(np.isfinite(gaps32)), "problem: non-finite f32 covariance blocks")
    ctx["report"].setdefault("problem", {}).update(
        sphere2500=dict(build_ms=1e3 * t_build, solve_ms=1e3 * t_solve, blocks_s=t_blocks, cov_f32_ms=1e3 * t_cov32,
                        cov_f64_ms=1e3 * t_cov64, gaps_f64=gaps64, gaps_f32=gaps32))
    log(f"phase 43 (sphere2500 through Problem): {time.perf_counter() - t_phase!r} s")


def implicit_phase(ctx):
    """Phase 44: ``solve_implicit`` at bench config 2's size,
    ``se2_manhattan(3500, seed=1)`` in f64 (10,500 dof, the dense path) with
    ``tests/test_diff.py``'s options: the gradient of the last pose's
    translation summed plus 0.1 chi2 with respect to every ``T_obs``, held
    to central differences (eps 1e-5, warm-started at the optimum) at its
    three largest entries and to the JAX reference's gradient
    (``chip_smoke_refs.npz``: its norm and 64 largest entries).  The
    backward's sums must be the ``slot_reduce`` kernel, never the plain
    assembly."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.graph.core import FactorBatch, FactorGraph
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import solve, solve_implicit
    from pyslam_tpu_torch.solver.lm import Options

    drive = ctx["drive"]
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))
    t_phase = time.perf_counter()
    g = build.pose_graph(synth.se2_manhattan(n_poses=3500, seed=1), dtype=torch.float64)
    fb = g.batches[0]
    opts = Options(method="lm", max_iters=60, min_cost_decrease=1 - 1e-13, min_update_norm=1e-14)

    def with_T(T_obs, blocks=g.blocks):
        return FactorGraph(blocks, [FactorBatch(fb.kind, fb.slots, fb.indices, {**fb.data, "T_obs": T_obs}, fb.loss,
                                                fb.weight)])

    def gradient():
        T = fb.data["T_obs"].clone().requires_grad_()
        values, chi2 = solve_implicit(with_T(T), opts)
        return torch.autograd.grad(values["poses"][-1, :2, 2].sum() + 0.1 * chi2, T)[0]

    # the first call pays the autograd engine's and torch.func's start on
    # the card; its time is logged apart from the measured call's
    t0 = time.perf_counter()
    first = gradient()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    T = fb.data["T_obs"].clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (values, chi2), l_fwd, r_fwd = drive("implicit_m3500", lambda: solve_implicit(with_T(T), opts), ("slot_reduce",))
    objective = values["poses"][-1, :2, 2].sum() + 0.1 * chi2
    t_fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    (grad,), l_bwd, _ = drive("implicit_m3500_backward", lambda: torch.autograd.grad(objective, T), ("slot_reduce",))
    t_bwd = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(torch.isfinite(grad).all().item() and torch.equal(grad, first),
          "implicit: a non-finite gradient, or two calls that differ in their bits")
    flat = grad.flatten()
    top = torch.as_tensor(refs["p44_top_idx"], device=flat.device)
    gap_top = rel_gap(flat[top], refs["p44_top_vals"])
    gap_norm = abs(grad.norm().item() - float(refs["p44_grad_norm"])) / float(refs["p44_grad_norm"])
    gap_chi2 = abs(chi2.item() - float(refs["p44_chi2"])) / float(refs["p44_chi2"])

    # central differences at the three largest entries, each solve started
    # at the optimum
    solved = {"poses": type(g.blocks["poses"])(g.blocks["poses"].kind, values["poses"].detach(),
                                                g.blocks["poses"].const_mask)}

    def f(T_obs):
        out, info = solve(with_T(T_obs, solved), opts)
        return (out.blocks["poses"].values[-1, :2, 2].sum() + 0.1 * info.chi2).item()

    eps = 1e-5
    fd = []
    t0 = time.perf_counter()
    for k in refs["p44_top_idx"][:3]:
        e, a, b = np.unravel_index(int(k), tuple(grad.shape))
        Tp, Tm = fb.data["T_obs"].clone(), fb.data["T_obs"].clone()
        Tp[e, a, b] += eps
        Tm[e, a, b] -= eps
        fd.append(((f(Tp) - f(Tm)) / (2 * eps), grad[e, a, b].item()))
    t_fd = time.perf_counter() - t0
    log(f"implicit m3500 f64 (D = {g.total_dof}): first call (forward and backward) {1e3 * t_first!r} ms; "
        f"forward {1e3 * t_fwd!r} ms ({r_fwd['lm']} LM iterations, launches "
        f"{l_fwd}), backward {1e3 * t_bwd!r} ms (launches {l_bwd}), peak memory {peak} B; objective "
        f"{objective.item()!r} (reference {float(refs['p44_value'])!r}), chi2 gap {gap_chi2!r}; gradient against the "
        f"JAX reference: 64 largest entries {gap_top!r}, norm {gap_norm!r}; central differences (fd, grad) {fd} in "
        f"{t_fd!r} s")
    check(l_bwd["slot_reduce"] > 0, "implicit: the backward launched no slot_reduce")
    check(gap_chi2 <= 1e-8, f"implicit: chi2 {gap_chi2} from the reference")
    check(gap_top <= 1e-6 and gap_norm <= 1e-6, f"implicit: gradient {gap_top} / {gap_norm} from the reference")
    for fd_k, g_k in fd:
        check(abs(g_k - fd_k) <= 2e-3 + 1e-2 * abs(fd_k), f"implicit: gradient {g_k} against central difference {fd_k}")
    ctx["report"].setdefault("problem", {}).update(
        implicit_m3500=dict(first_call_ms=1e3 * t_first, forward_ms=1e3 * t_fwd, backward_ms=1e3 * t_bwd, backward_slot_reduce=l_bwd["slot_reduce"],
                            peak_bytes=peak, gap_top=gap_top, gap_norm=gap_norm))
    log(f"phase 44 (solve_implicit at config 2's size): {time.perf_counter() - t_phase!r} s")


def autodiff_phase(ctx):
    """Phase 45: an autodiff clone of ``between_se3``
    (``register_autodiff_factor``, ``torch.func.jacfwd``) on the card: its
    Jacobians on sphere2500 in f64 within 1e-10 of the analytic kernel's;
    sphere2500 solved through it in f32 (``solve_auto``: route ``ell``, the
    general assembly, ``slot_reduce`` at widths 36 and 6 and no
    ``ell_assemble``) under the sphere2500 gate; ``check_autodiff_factor``
    refusing a row-coupled residual."""
    import torch

    from pyslam_tpu_torch.graph import FACTOR_KERNELS, build, check_autodiff_factor, register_autodiff_factor
    from pyslam_tpu_torch.graph.core import FactorBatch, FactorGraph
    from pyslam_tpu_torch.lie import se3
    from pyslam_tpu_torch.solver import route_auto, solve_auto
    from pyslam_tpu_torch.solver.lm import Options

    drive, gate = ctx["drive"], ctx["gate"]
    t_phase = time.perf_counter()

    def between(data, T1, T2):
        r = se3.log(T2 @ se3.inv(T1) @ se3.inv(data["T_obs"]))
        return (data["sqrt_info"] @ r[..., None])[..., 0]

    register_autodiff_factor("between_se3_autodiff", between, ("se3", "se3"))
    g64 = build.pose_graph(ctx["sphere_data"], dtype=torch.float64)
    fb = g64.batches[0]
    vals = [g64.blocks["poses"].values[idx] for idx in fb.indices]
    t_ad = []
    for _ in range(2):  # the first call pays torch.func's start on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_d, jac_d = FACTOR_KERNELS["between_se3_autodiff"](fb.data, *vals)
        torch.cuda.synchronize()
        t_ad.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    r_a, jac_a = FACTOR_KERNELS["between_se3"](fb.data, *vals)
    torch.cuda.synchronize()
    t_an = time.perf_counter() - t0
    gaps = [rel_gap(r_d, r_a)] + [rel_gap(d, a) for d, a in zip(jac_d, jac_a)]

    g = ctx["sphere"]
    gb = g.batches[0]
    clone = FactorGraph(g.blocks, [FactorBatch("between_se3_autodiff", gb.slots, gb.indices, gb.data, gb.loss,
                                               gb.weight)])
    opts = Options(method="lm", max_iters=30, min_cost_decrease=0.999)
    t0 = time.perf_counter()
    (solved, info), launches, reads = drive("autodiff_sphere2500", lambda: solve_auto(clone, opts),
                                            ("slot_reduce", "ell_pcg"))
    t_solve = time.perf_counter() - t0
    coupled_refused = False

    def coupled(data, x):
        r = x - data["obs"]
        return r / r.std()

    register_autodiff_factor("coupled_demo", coupled, ("euclidean",))
    gen = torch.Generator(device=ctx["dev"]).manual_seed(SEED)
    try:
        check_autodiff_factor("coupled_demo", {"obs": torch.randn((6, 3), generator=gen, device=ctx["dev"])},
                              torch.randn((6, 3), generator=gen, device=ctx["dev"]))
    except ValueError:
        coupled_refused = True
    log(f"autodiff between_se3 on sphere2500 f64 ({fb.n} factors): residual and Jacobian gaps to the analytic kernel "
        f"{gaps!r}, jacfwd {t_ad[0]!r} ms (first call), {t_ad[1]!r} ms, against the analytic {1e3 * t_an!r} ms; "
        f"solve through the clone f32: route "
        f"{route_auto(clone)!r}, {1e3 * t_solve!r} ms, LM iterations {info.iterations}, chi2 {info.chi2.item()!r}, "
        f"launches {launches}, host reads {reads}; coupled residual refused {coupled_refused}")
    check(max(gaps) <= 1e-10, f"autodiff: {gaps} from the analytic kernel")
    check(route_auto(clone) == "ell" and launches["ell_assemble"] == 0,
          f"autodiff: route {route_auto(clone)!r}, launches {launches}: the general assembly expected")
    check(launches["ell_pcg"] == info.iterations, f"autodiff: {launches['ell_pcg']} ell_pcg launches")
    check(coupled_refused, "autodiff: check_autodiff_factor took a row-coupled residual")
    gate("autodiff sphere2500", info.chi2.item(), 1.001, ctx["chi2_ref"])
    ctx["report"].setdefault("problem", {}).update(
        autodiff_sphere2500=dict(jacfwd_first_ms=t_ad[0], jacfwd_ms=t_ad[1], analytic_ms=1e3 * t_an, solve_ms=1e3 * t_solve, gaps=gaps))
    log(f"phase 45 (autodiff factors): {time.perf_counter() - t_phase!r} s")


def api_phases(ctx):
    """Phases 43 to 45."""
    if ctx["want"](43):
        problem_phase(ctx)
    if ctx["want"](44):
        implicit_phase(ctx)
    if ctx["want"](45):
        autodiff_phase(ctx)


# the VO phases' holds on a trajectory, per frame, in translation (m) and
# rotation (rad), float32 in both packages.  VO_TOL holds the sequential,
# prefetched, stereo and affine runs to the reference's and the batch to
# the port's sequential run: the CPU rehearsal of the port came within
# 7.1e-5 (RGB-D), 6.3e-5 (stereo) and 1.1e-5 (affine) of the reference,
# the batch within 1.2e-5 of the sequential run; on an H100 5.5e-5 and
# 1.8e-5.  VO_BATCH_REF_TOL holds the batch to the reference's batch only:
# a level's LM stops on a relative cost decrease of 1e-4, a test that
# float32 rounding can flip, and the reference's own track_batch at VGA
# departs from its sequential run by 5.6e-4 at frame 24 (the port's batch
# 5.4e-4 from the reference's there, 2.4e-5 at the other frames).
VO_TOL = 2e-4
VO_BATCH_REF_TOL = 1e-3
# stereo SLAM's ATE at each stage against the reference's, relative: on the
# reference's samples the port's CPU run came within 1.2e-5, 4.5e-4 and
# 2.7e-3 (float32 rounding moves a few inliers at the 2 px threshold)
SLAM_ATE_TOL = 1e-2


def pose_gap(a, b):
    """(translation gap (m), rotation gap (rad)) of two stacks of poses, the
    largest over the frames; the angle from the skew part of Ra^T Rb."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dR = np.einsum("nji,njk->nik", a[:, :3, :3], b[:, :3, :3])
    skew = 0.5 * (dR - dR.transpose(0, 2, 1))
    ang = np.arcsin(np.clip(np.linalg.norm(skew[:, [2, 0, 1], [1, 2, 0]], axis=-1), 0.0, 1.0))
    return float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max()), float(ang.max())


def syncs_and_reads(fn):
    """(synchronizing calls, LM host reads) of one call of ``fn``."""
    from pyslam_tpu_torch.solver import linear

    linear.reset_host_reads()
    _, syncs = sync_count(fn)
    return syncs, linear.HOST_READS["lm"]


def frame_profile(run, n):
    """(kernels a frame, device ms a frame) of ``run()``, which tracks n
    frames, under ``torch.profiler`` (CUDA activity): the device events
    (kernels, copies, fills) read from the tracer's own records, which
    skips building ``key_averages``' Python event tree (seconds for the
    15,000 launches of three VGA frames)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CUDA]
    return len(dev) / n, sum(e.duration_ns() for e in dev) / 1e6 / n


def vo_rgbd_phase(ctx):
    """Phase 46: dense RGB-D VO at VGA (``bench/vo_overlap.py``'s 40 uint8
    frames, 4 levels, ``pixel_budget=24576``, ``keyframe_trans_thresh=1e9``)
    through ``DenseRGBDPipeline.track`` frame by frame, then ``prefetch`` +
    ``track``, then ``track_batch`` at K = 16 on ``bench/vo_batch.py``'s
    protocol (the first frame, then 32 frames in two batches, after a
    warm-up batch on another pipeline). Every frame's pose is held to the
    reference's trajectory (``chip_smoke_refs.npz``), the batch also to the
    sequential run; ``slot_reduce`` at the single-pose graph's and the
    batch's sums; the ATE against the ground truth by ``TrajectoryMetrics``;
    ms a frame, fps, kernels and device ms a frame, synchronizing calls a
    frame, peak memory."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.eval import TrajectoryMetrics
    from pyslam_tpu_torch.pipelines import DenseRGBDPipeline
    from pyslam_tpu_torch.pipelines.dense import _track_input
    from pyslam_tpu_torch.sensors import RGBDCamera
    from pyslam_tpu_torch.solver.assemble import dense_plan
    from pyslam_tpu_torch.solver.batched import _union
    from pyslam_tpu_torch.testing import VO_CAM, vo_frames, vo_truth

    dev, drive, report = ctx["dev"], ctx["drive"], ctx["report"]
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))
    t_phase = time.perf_counter()
    frames = vo_frames(40)
    truth = vo_truth(40)
    marks = [("frames made", time.perf_counter())]

    def pipeline():
        return DenseRGBDPipeline(RGBDCamera(**VO_CAM), pyrlevels=4, keyframe_trans_thresh=1e9, device=dev)

    # frame by frame: the per-frame host clock from the call to the pose
    # read back (each frame's last act)
    seq, walls = pipeline(), []

    def run_seq():
        for im, depth in frames:
            t0 = time.perf_counter()
            seq.track(im, depth)
            walls.append(time.perf_counter() - t0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, launches, reads = drive("vo_rgbd_vga", run_seq, ("slot_reduce",))
    peak = torch.cuda.max_memory_allocated()
    T_seq = np.stack(seq.T_c_w)
    steady = walls[2:]  # the keyframe, and the first solve's start on the card, apart
    gap = pose_gap(T_seq, refs["p46_seq"])
    ate = TrajectoryMetrics(np.linalg.inv(truth), np.linalg.inv(T_seq), device=dev).armse("trans").item()

    marks.append(("frame by frame", time.perf_counter()))

    # the same frames prefetched: the next frame's pinned copy queued before
    # this frame's solve
    pre, pwalls = pipeline(), []
    n_pre = len(frames)

    def run_pre():
        pre.track(*frames[0])
        h = pre.prefetch(frames[1][0])
        for k in range(1, n_pre):
            t0 = time.perf_counter()
            h_next = pre.prefetch(frames[k + 1][0]) if k + 1 < n_pre else None
            pre.track(h, frames[k][1])
            pwalls.append(time.perf_counter() - t0)
            h = h_next

    _, pre_launches, _ = drive("vo_rgbd_vga_prefetch", run_pre, ("slot_reduce",))
    T_pre = np.stack(pre.T_c_w)
    gap_pre = pose_gap(T_pre, refs["p46_seq"][:n_pre])

    marks.append(("prefetched", time.perf_counter()))

    # track_batch at K = 16
    ims = [im for im, _ in frames[1:]]
    warm = pipeline()
    warm.track(*frames[0])
    warm.track_batch(ims[:16])
    bat = pipeline()
    bat.track(*frames[0])
    bwalls = []

    def run_batch():
        for s in range(0, 32, 16):
            t0 = time.perf_counter()
            bat.track_batch(ims[s: s + 16])
            bwalls.append(time.perf_counter() - t0)

    _, b_launches, b_reads = drive("vo_rgbd_vga_batch16", run_batch, ("slot_reduce",))
    T_bat = np.stack(bat.T_c_w)
    gap_b = pose_gap(T_bat, refs["p46_batch"])
    gap_bs = pose_gap(T_bat, T_seq[:33])
    fps_seq, fps_pre, fps_bat = 1.0 / float(np.median(steady)), 1.0 / float(np.median(pwalls[1:])), 32 / sum(bwalls)

    marks.append(("track_batch", time.perf_counter()))

    # per frame: kernels, device ms, synchronizing calls; the dense plan's cost
    more = pipeline()
    more.track(*frames[0])
    more.track(*frames[1])
    n_kernels, dev_ms = frame_profile(lambda: [more.track(im, d) for im, d in frames[2:5]], 3)
    marks.append(("profiled frames", time.perf_counter()))
    syncs, syncs_reads = syncs_and_reads(lambda: more.track(*frames[7]))
    h = more.prefetch(frames[9][0])
    more.track(*frames[8])
    syncs_pre, syncs_pre_reads = syncs_and_reads(lambda: more.track(h, frames[9][1]))
    marks.append(("synchronizing calls", time.perf_counter()))
    b_kernels, b_dev_ms = frame_profile(lambda: bat.track_batch(ims[:16]), 16)
    marks.append(("profiled batch", time.perf_counter()))
    kf = more.keyframes[0]
    pyr = more._track_pyramid(torch.from_numpy(_track_input(frames[10][0])).to(dev))
    T0 = torch.eye(4, device=dev)
    graph = more._graph(T0, more._level_data(kf.levels[0], pyr[0]), more.loss)
    t_plan = host_ms(lambda: dense_plan(graph))
    dense_slot_reduce("vo_rgbd_vga level 0", graph, report, "vo_rgbd_vga_ms")
    K16 = [more._graph(T0, {k: (v[b: b + 1] if torch.is_tensor(v) else v) for k, v in
                            more._level_data(kf.levels[0], torch.stack([pyr[0]] * 16), 16).items()}, more.loss)
           for b in range(16)]
    dense_slot_reduce("vo_rgbd_vga track_batch K = 16, level 0", _union(K16), report, "vo_rgbd_vga_batch16_ms")
    marks.append(("slot_reduce holds", time.perf_counter()))

    log(f"vo_rgbd_vga (40 frames 640 x 480, 4 levels, 24,576 pixels a level): per frame {spread(steady)}, "
        f"{fps_seq!r} fps; launches {launches}, LM host reads {reads['lm']} "
        f"({reads['lm'] / (len(frames) - 1)!r} a frame); peak memory {peak} B; gap to the reference (translation m, "
        f"rotation rad) {gap!r}; ATE against the ground truth {ate!r} m (TrajectoryMetrics.armse)")
    log(f"vo_rgbd_vga prefetched ({n_pre} frames): per frame {spread(pwalls[1:])}, {fps_pre!r} fps; launches "
        f"{pre_launches}; gap to the reference {gap_pre!r}; the same bits as frame by frame "
        f"{np.array_equal(T_pre, T_seq[:n_pre])}")
    log(f"vo_rgbd_vga track_batch K = 16: two batches {[1e3 * w for w in bwalls]!r} ms, {fps_bat!r} fps "
        f"({fps_bat / fps_seq!r} x frame by frame); launches {b_launches}, LM host reads {b_reads['lm']}; gap to the "
        f"reference's track_batch {gap_b!r}, to the sequential run {gap_bs!r}")
    log(f"vo_rgbd_vga per frame: {n_kernels!r} kernels, {dev_ms!r} device ms (3 frames under torch.profiler); "
        f"track_batch {b_kernels!r} kernels and {b_dev_ms!r} device ms a frame; synchronizing calls a frame "
        f"{syncs} (track; {syncs_reads} of them LM reads), {syncs_pre} (prefetched track; {syncs_pre_reads} LM reads); "
        f"dense_plan of the single-pose graph {t_plan!r} host ms "
        f"(built once, then found by content in the plan cache at every level and frame)")
    check(np.isfinite(T_seq).all() and np.isfinite(T_bat).all(), "vo_rgbd_vga: non-finite poses")
    check(max(gap) <= VO_TOL and max(gap_pre) <= VO_TOL, f"vo_rgbd_vga: {gap} / {gap_pre} from the reference")
    check(max(gap_b) <= VO_BATCH_REF_TOL and max(gap_bs) <= VO_TOL,
          f"vo_rgbd_vga track_batch: {gap_b} from the reference's, {gap_bs} from the sequential run")
    report.setdefault("vo", {}).update(vo_rgbd_vga=dict(
        ms_median=1e3 * float(np.median(steady)), ms_p90=1e3 * float(np.percentile(steady, 90)), fps=fps_seq,
        prefetch_fps=fps_pre, batch16_fps=fps_bat, kernels_per_frame=n_kernels, device_ms_per_frame=dev_ms,
        syncs_per_frame=(syncs, syncs_reads), syncs_per_prefetched_frame=(syncs_pre, syncs_pre_reads),
        slot_reduce=launches["slot_reduce"],
        slot_reduce_batch16=b_launches["slot_reduce"], peak_bytes=peak, gap=gap, gap_batch=gap_b, ate=ate))
    log(f"phase 46 (VGA RGB-D VO): {time.perf_counter() - t_phase!r} s (by part: "
        f"{ {name: round(t - t0, 3) for (_, t0), (name, t) in zip([('', t_phase)] + marks, marks)} } s); {ctx['smi']}")


def vo_stereo_phase(ctx):
    """Phase 47: dense stereo VO at VGA with the on-device block matcher
    (``matcher="tpu"``, 128 disparities) on 16 uint8 stereo frames along
    the benchmark's path of a plane textured with the reference matcher
    test's noise (``testing.vo_stereo_frames``): the keyframe's disparity
    map held to the reference's (NaN masks equal, values within 1e-4), the
    trajectory to the reference's; then ``affine_illumination=True``
    through an exposure ramp (``testing.exposure_ramp``), its keyframe on
    the matcher's map too, held to the reference's. The default run tracks
    the first 8 frames of each, a selection of the phase all 16."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.eval import TrajectoryMetrics
    from pyslam_tpu_torch.pipelines import DenseStereoPipeline
    from pyslam_tpu_torch.pipelines.keyframes import compute_disparity
    from pyslam_tpu_torch.sensors import StereoCamera
    from pyslam_tpu_torch.testing import VO_CAM, exposure_ramp, vo_stereo_frames, vo_truth

    dev, drive, report = ctx["dev"], ctx["drive"], ctx["report"]
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))
    t_phase = time.perf_counter()
    n = 16 if ctx["selected"] else 8
    frames = vo_stereo_frames(n)
    truth = vo_truth(n)
    cam = StereoCamera(b=0.3, **VO_CAM)

    left, right = frames[0][0], frames[0][1]
    disp = compute_disparity(left, right, "tpu", device=dev)
    t_match = host_ms(lambda: compute_disparity(left, right, "tpu", device=dev), reps=3)
    n_match_kernels, match_dev_ms = frame_profile(lambda: compute_disparity(left, right, "tpu", device=dev), 1)
    ref_disp = refs["p47_disp"]
    valid = np.isfinite(ref_disp)
    masks_equal = bool(np.array_equal(np.isfinite(disp), valid))
    disp_err = float(np.abs(disp[valid] - ref_disp[valid]).max()) if valid.any() else 0.0
    same_bits = masks_equal and bool(np.array_equal(disp[valid], ref_disp[valid]))

    runs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, affine in (("vo_stereo_vga", False), ("vo_stereo_vga_affine", True)):
        pipe, walls = DenseStereoPipeline(cam, pyrlevels=4, keyframe_trans_thresh=1e9, matcher="tpu",
                                          affine_illumination=affine, device=dev), []

        def run(pipe=pipe, walls=walls, affine=affine):
            for k, (im_l, im_r, _) in enumerate(frames):
                t0 = time.perf_counter()
                pipe.track(exposure_ramp(im_l, k) if affine else im_l, im_r)
                walls.append(time.perf_counter() - t0)

        _, launches, reads = drive(name, run, ("slot_reduce",))
        T = np.stack(pipe.T_c_w)
        ref = refs["p47_affine" if affine else "p47_seq"][:n]
        syncs = syncs_and_reads(lambda: pipe.track(exposure_ramp(frames[-1][0], n) if affine else frames[-1][0],
                                                   frames[-1][1]))
        # one more frame under torch.profiler (the plain run's; the affine
        # kernel adds its sums to the same shapes)
        profiled = None if affine else frame_profile(lambda: pipe.track(frames[1][0], frames[1][1]), 1)
        runs[name] = dict(walls=walls[2:], launches=launches, reads=reads, gap=pose_gap(T, ref), syncs=syncs,
                          profiled=profiled,
                          ate=TrajectoryMetrics(np.linalg.inv(truth), np.linalg.inv(T), device=dev).armse("trans")
                          .item(), first_ms=1e3 * walls[0])
    log(f"vo_stereo_vga keyframe disparity (block_match, 480 x 640, 128 disparities): {t_match!r} host ms (median of "
        f"3), {n_match_kernels!r} kernels, {match_dev_ms!r} device ms; valid {float(valid.mean())!r}; against the "
        f"reference: NaN masks equal {masks_equal}, max error {disp_err!r}, the same bits {same_bits}")
    for name, r in runs.items():
        log(f"{name}: keyframe frame {r['first_ms']!r} ms; per frame {spread(r['walls'])}, "
            f"{1.0 / float(np.median(r['walls']))!r} fps; launches {r['launches']}, LM host reads {r['reads']['lm']}; "
            f"synchronizing calls of one more frame {r['syncs'][0]} ({r['syncs'][1]} LM reads); "
            + (f"{r['profiled'][0]!r} kernels and {r['profiled'][1]!r} device ms a frame (one under torch.profiler); "
               if r["profiled"] else "") + f"gap to the reference {r['gap']!r}; ATE {r['ate']!r} m")
    peak = torch.cuda.max_memory_allocated()
    check(masks_equal and disp_err <= 1e-4, f"vo_stereo_vga: disparity masks equal {masks_equal}, error {disp_err}")
    for name, r in runs.items():
        check(max(r["gap"]) <= VO_TOL, f"{name}: {r['gap']} from the reference")
    report.setdefault("vo", {}).update(vo_stereo_vga=dict(
        match_ms=t_match, match_kernels=n_match_kernels, match_device_ms=match_dev_ms, disp_error=disp_err,
        peak_bytes=peak,
        **{f"{n}_{k}": v for n, r in runs.items() for k, v in
           (("ms_median", 1e3 * float(np.median(r["walls"]))), ("ms_p90", 1e3 * float(np.percentile(r["walls"], 90))),
            ("syncs_per_frame", r["syncs"]), ("slot_reduce", r["launches"]["slot_reduce"]), ("gap", r["gap"]))}))
    log(f"phase 47 (VGA stereo VO): {time.perf_counter() - t_phase!r} s; peak memory {peak} B; {ctx['smi']}")


def stereo_slam_phase(ctx):
    """Phase 48: ``examples/stereo_slam.py``'s pipeline at its size (40
    frames, 4,000 points, a 640 x 480 stereo camera) on the port in float32
    (``testing.stereo_slam``): the RANSAC odometry chain and loop closures
    (each with its LM polish), the pose graph (``solver.solve``) and joint
    SLAM through ``solve_auto``; each RANSAC call given the reference's
    samples (``chip_smoke_refs.npz``), the ATE of each stage held to the
    reference's; then the port's own draw (a ``torch.Generator``), its
    joint-SLAM ATE within 10% of the reference's. ``slot_reduce``'s
    launches are counted by stage, and the arguments of its first launch at
    each plan and width of the run are recorded (``record_slot_reduce``)
    and held to the plain version afterwards: every polish shape, the pose
    graph's dense sums and the Schur route's segment sums; the largest of
    each stage is also timed."""
    import numpy as np
    import torch

    from pyslam_tpu_torch.pipelines import FrameToFrameRANSAC
    from pyslam_tpu_torch.sensors import StereoCamera
    from pyslam_tpu_torch.solver import cuda_ops
    from pyslam_tpu_torch.testing import SLAM_CAM, stereo_slam, stereo_slam_world

    dev, drive, report = ctx["dev"], ctx["drive"], ctx["report"]
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))
    t_phase = time.perf_counter()
    world, gt, frames = stereo_slam_world(n_frames=40, seed=0)
    samples = dict(zip(refs["p48_sample_counts"].tolist(), refs["p48_samples"]))
    stage_ms, stage_launches, calls = {}, {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        n0, t0 = cuda_ops.LAUNCHES["slot_reduce"], time.perf_counter()
        with record_slot_reduce(calls.setdefault(name, {})):
            out = fn()
            torch.cuda.synchronize()
        stage_ms[name] = 1e3 * (time.perf_counter() - t0)
        stage_launches[name] = cuda_ops.LAUNCHES["slot_reduce"] - n0
        return out

    stages = dict(odometry=timed, pose_graph=timed, joint=timed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches, reads = drive("stereo_slam_40", lambda: stereo_slam(world, gt, frames, device=dev, samples=samples,
                                                                        stages=stages), ("slot_reduce",))
    wall = time.perf_counter() - t0
    ate = np.array([out["ate_odometry"], out["ate_pose_graph"], out["ate_joint"]])
    rel = np.abs(ate - refs["p48_ate"]) / refs["p48_ate"]
    peak = torch.cuda.max_memory_allocated()
    own = stereo_slam(world, gt, frames, device=dev)
    own_ate = np.array([own["ate_odometry"], own["ate_pose_graph"], own["ate_joint"]])

    # a frame of the odometry: one RANSAC call on a consecutive pair
    ransac = FrameToFrameRANSAC(StereoCamera(**SLAM_CAM), num_iters=256, inlier_thresh=2.0, device=dev)
    pairs = []
    for k in range(1, 12):
        _, ia, ib = np.intersect1d(frames[k - 1][0], frames[k][0], return_indices=True)
        pairs.append((frames[k - 1][1][ia].astype(np.float32), frames[k][1][ib].astype(np.float32)))
    steps = []
    for a, b in pairs:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ransac.compute_transform(a, b)
        steps.append(time.perf_counter() - t1)
    step_kernels, step_dev_ms = frame_profile(lambda: [ransac.compute_transform(a, b) for a, b in pairs[:3]], 3)
    step_syncs, step_reads = syncs_and_reads(lambda: ransac.compute_transform(*pairs[0]))

    # slot_reduce against its plain version at every recorded launch; the
    # largest of each stage also timed
    for stage, recorded in calls.items():
        items = list(recorded.values())
        largest = max(range(len(items)), key=lambda i: items[i][0].numel())
        worst, shapes = 0.0, []
        for i, (contrib, perm, offsets, n_slots, longest) in enumerate(items):
            args = [contrib, perm, offsets, n_slots]
            shapes.append(f"{tuple(contrib.shape)} into {n_slots}")
            if i == largest:
                check_kernel("slot_reduce", *slot_fns(longest), args, report,
                             f"stereo_slam_40_{stage}_ms", flop=contrib.numel(),
                             library=index_add_library(contrib, perm, offsets, n_slots))
            else:
                worst = max(worst, hold_kernel("slot_reduce", *slot_fns(longest), args, report, quiet=True))
        log(f"stereo_slam_40 {stage}: slot_reduce held at {len(recorded)} plans and widths "
            f"({', '.join(shapes[:8])}{', ...' if len(shapes) > 8 else ''}), {shapes[largest]} timed; the others' "
            f"largest relative error {worst!r}")
    log(f"stereo_slam_40 on the reference's samples: {wall!r} s ({ {k: round(v, 3) for k, v in stage_ms.items()} } ms "
        f"by stage), {out['edges']} edges ({out['loops']} loop closures), pose graph {out['pose_graph_iterations']} "
        f"LM iterations, joint {out['joint_iterations']} ({out['landmarks']} landmarks, {out['observations']} "
        f"observations); launches {launches} (slot_reduce by stage {stage_launches}, at "
        f"{ {k: len(v) for k, v in calls.items()} } plans and widths), LM host reads {reads['lm']}; "
        f"ATE {ate.tolist()!r} m against the reference's {refs['p48_ate'].tolist()!r} (relative gaps {rel.tolist()!r})")
    log(f"stereo_slam_40 on the port's own draw: ATE {own_ate.tolist()!r} m; peak memory {peak} B")
    log(f"stereo_slam_40 odometry step (one compute_transform, 256 hypotheses, LM 10 polish): {spread(steps[1:])}, "
        f"{1.0 / float(np.median(steps[1:]))!r} a second; {step_kernels!r} kernels and {step_dev_ms!r} device ms a "
        f"step; synchronizing calls {step_syncs} ({step_reads} LM reads)")
    check(sum(stage_launches.values()) == launches["slot_reduce"], f"stereo_slam_40: launches by stage {stage_launches}")
    check(all(stage_launches.values()), f"stereo_slam_40: a stage launched no slot_reduce: {stage_launches}")
    check(np.isfinite(ate).all() and rel.max() <= SLAM_ATE_TOL, f"stereo_slam_40: ATE {ate} against {refs['p48_ate']}")
    check(abs(own_ate[2] - refs["p48_ate"][2]) <= 0.1 * refs["p48_ate"][2],
          f"stereo_slam_40 own draw: joint ATE {own_ate[2]} against the reference's {refs['p48_ate'][2]}")
    report.setdefault("vo", {}).update(stereo_slam_40=dict(
        wall_s=wall, stage_ms=stage_ms, ate=ate.tolist(), own_ate=own_ate.tolist(), slot_reduce=launches["slot_reduce"],
        slot_reduce_by_stage=stage_launches, peak_bytes=peak, step_ms_median=1e3 * float(np.median(steps[1:])),
        step_kernels=step_kernels, step_device_ms=step_dev_ms, step_syncs=step_syncs))
    log(f"phase 48 (stereo SLAM): {time.perf_counter() - t_phase!r} s; {ctx['smi']}")


@contextlib.contextmanager
def record_slot_reduce(calls):
    """Within the block, every ``slot_reduce`` launch (``cuda_ops``'s
    ``_slot_reduce``, behind the autograd wrapper too) also records its
    arguments into ``calls`` the first time it meets a plan and width:
    (perm's address, n_slots, contrib's shape) -> (contrib, perm, offsets,
    n_slots, longest). The launch itself, and its count, are unchanged."""
    from pyslam_tpu_torch.solver import cuda_ops

    inner = cuda_ops._slot_reduce

    def recorded(contrib, perm, offsets, n_slots, longest=None):
        calls.setdefault((perm.data_ptr(), n_slots, tuple(contrib.shape)), (contrib, perm, offsets, n_slots, longest))
        return inner(contrib, perm, offsets, n_slots, longest)

    cuda_ops._slot_reduce = recorded
    try:
        yield calls
    finally:
        cuda_ops._slot_reduce = inner


@contextlib.contextmanager
def record_moved_bodies(old, moved, driven):
    """Within the block, every ``slot_reduce`` launch (``cuda_ops``'s
    ``_slot_reduce``) is also put to the body rule of ``old``, another
    checkout's ``cuda_ops`` (``parent_cuda_ops``).  Where that rule gives
    another body, the launch counts in ``moved``: (where, rows, destinations,
    width, longest, dtype) -> [this body, its body, launches, perm, offsets],
    where ``where`` is the main path being driven (``driven()``, None
    outside one) and the innermost function and line of this file that led
    to the launch.  The launch itself, and its count, are unchanged."""
    from pyslam_tpu_torch.solver import cuda_ops

    inner = cuda_ops._slot_reduce

    def recorded(contrib, perm, offsets, n_slots, longest=None):
        E, C = contrib.shape
        this, theirs = cuda_ops.slot_reduce_body(E, n_slots, C, longest), old.slot_reduce_body(E, n_slots, C, longest)
        if this != theirs:
            frame = sys._getframe(1)
            while frame is not None and frame.f_globals is not globals():
                frame = frame.f_back
            site = f"{frame.f_code.co_name}:{frame.f_lineno}" if frame is not None else "?"
            key = (f"{driven() or 'outside a main path'} ({site})", E, n_slots, C, longest,
                   str(contrib.dtype).split(".")[-1])
            moved.setdefault(key, [this, theirs, 0, perm, offsets])[2] += 1
        return inner(contrib, perm, offsets, n_slots, longest)

    cuda_ops._slot_reduce = recorded
    try:
        yield moved
    finally:
        cuda_ops._slot_reduce = inner


def time_moved_bodies(moved, old, rounds=2):
    """Each plan of ``record_moved_bodies`` on seeded rows of its shape:
    this checkout's ``slot_reduce`` and ``old``'s (another checkout's
    ``cuda_ops``) both within ``REL_TOL`` of the plain version, their device
    times in turns (theirs, this, this, theirs; ``rounds`` of each, each the
    median of 5 measurements of 5 calls back to back), ``index_add_`` and
    the bound beside; then the launches that moved by main path."""
    import functools

    import torch

    from pyslam_tpu_torch.solver import cuda_ops

    by_path = {}
    for (where, E, n_slots, C, longest, tname), (this, theirs, launches, perm, offsets) in moved.items():
        by_path[where.split(" (")[0]] = by_path.get(where.split(" (")[0], 0) + launches
        gen = torch.Generator(device=perm.device).manual_seed(E)
        contrib = torch.randn((E, C), generator=gen, device=perm.device, dtype=getattr(torch, tname))
        args = [contrib, perm, offsets, n_slots]
        sides = {"parent": functools.partial(old.slot_reduce, longest=longest),
                 "this": functools.partial(cuda_ops.slot_reduce, longest=longest)}
        ref = cuda_ops.slot_reduce_plain(*args)
        scale = ref.abs().max().item()
        for side, fn in sides.items():
            err = (fn(*args) - ref).abs().max().item()
            check(err <= REL_TOL[tname] * scale, f"moved body {where} {side}: error {err} > {REL_TOL[tname]} * {scale}")
        times = {side: [] for side in sides}
        for _ in range(rounds):
            for side in ("parent", "this", "this", "parent"):
                times[side].append(1e3 * median_ms(sides[side], args, calls=5, inner=5))
        lib_us = 1e3 * median_ms(index_add_library(*args), (), calls=5, inner=5)
        b_ms, by = bound_ms(tensor_bytes(contrib, perm, offsets, ref), contrib.numel())
        log(f"slot_reduce body moved at {where}: {E} rows of {C} ({tname}) into {n_slots} (longest {longest}), "
            f"{launches} launches: this ({this}) {statistics.median(times['this'])!r} us (spread "
            f"{max(times['this']) - min(times['this'])!r}), parent ({theirs}) {statistics.median(times['parent'])!r} us "
            f"(spread {max(times['parent']) - min(times['parent'])!r}); index_add_ {lib_us!r} us; bound "
            f"{1e3 * b_ms!r} us by {by}")
        del contrib, ref, args
    log(json.dumps({"slot_reduce_moved_launches_by_path": by_path, "plans_moved": len(moved)}))


def vo_phases(ctx):
    """Phases 46 to 48."""
    if ctx["want"](46):
        vo_rgbd_phase(ctx)
    if ctx["want"](47):
        vo_stereo_phase(ctx)
    if ctx["want"](48):
        stereo_slam_phase(ctx)


def io_phase(ctx):
    """Phase 52: the g2o and BAL readers through the native tokenizer and
    through their plain versions, on a config 5 (Venice-mini) BAL file and
    config 2's g2o file: the same arrays, and the host time of each."""
    import pathlib
    import tempfile

    import numpy as np

    from pyslam_tpu_torch import native
    from pyslam_tpu_torch.io import bal, g2o, synth

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    native.available()
    log(f"native tokenizer build (g++, or the cached library): {time.perf_counter() - t0!r} s")

    def load_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times), out

    def same(a, b, label):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                check(x.dtype == y.dtype and np.array_equal(x, y), f"{label}: {f.name} differs native / plain")
            else:
                check(x == y, f"{label}: {f.name} differs native / plain")

    with tempfile.TemporaryDirectory() as td:
        files = {"venice_mini_bal": os.path.join(td, "venice_mini.bal"),
                 "config2_m3500_g2o": os.path.join(td, "m3500.g2o")}
        bal.write_bal(files["venice_mini_bal"], bal.synthetic_bal(300, 60000, obs_per_pt=6))
        g2o.write_g2o(files["config2_m3500_g2o"], synth.se2_manhattan(n_poses=3500, seed=1))
        readers = {
            "venice_mini_bal": (lambda p: bal.read_bal(p),
                                lambda p: bal.read_bal(p, _parse=bal._parse_bal_plain),
                                lambda p: native.parse_doubles(pathlib.Path(p).read_bytes()),
                                lambda p: bal._parse_bal_plain(pathlib.Path(p).read_bytes())),
            "config2_m3500_g2o": (lambda p: g2o.read_g2o(p),
                                  lambda p: g2o.read_g2o(p, _recs=g2o._tokenize_g2o_plain(p)),
                                  lambda p: g2o._tokenize_g2o(p),
                                  lambda p: g2o._tokenize_g2o_plain(p)),
        }
        for label, (fast, plain, tok_fast, tok_plain) in readers.items():
            path = files[label]
            ms, out = load_ms(lambda: fast(path))
            plain_ms, out_plain = load_ms(lambda: plain(path))
            same(out, out_plain, label)
            tok_ms, _ = load_ms(lambda: tok_fast(path))
            tok_plain_ms, _ = load_ms(lambda: tok_plain(path))
            log(f"phase 52 {label} ({os.path.getsize(path)} B), host ms, median of 3, {ctx['smi']}: "
                f"read native {ms!r} plain {plain_ms!r} ({plain_ms / ms!r}x); "
                f"tokenizer alone native {tok_ms!r} plain {tok_plain_ms!r} ({tok_plain_ms / tok_ms!r}x)")
    log(f"phase 52 (native tokenizer): {time.perf_counter() - t_phase!r} s")


def cross_check(label, res, rel=1e-8):
    """The CPU and card runs of one f64 solve: ``res[where] = (info,
    solved)``; the same iterations and stop code, chi2 within ``rel``
    relative, poses within 1e-6."""
    (i_c, s_c), (i_g, s_g) = res["cpu"], res["cuda"]
    c_c, c_g = i_c.chi2.item(), i_g.chi2.item()
    pose_err = (s_c.blocks["poses"].values - s_g.blocks["poses"].values.cpu()).abs().max().item()
    log(f"f64 {label}: cpu {i_c.iterations} it status {i_c.status} chi2 {c_c!r}; "
        f"cuda {i_g.iterations} it status {i_g.status} chi2 {c_g!r}; pose diff {pose_err!r}")
    check((i_c.iterations, i_c.status) == (i_g.iterations, i_g.status),
          f"{label}: CPU and CUDA paths took different iterations or stop codes")
    check(abs(c_c - c_g) <= rel * abs(c_c), f"{label}: CPU and CUDA chi2 differ by more than {rel} rel")
    check(pose_err <= 1e-6, f"{label}: CPU and CUDA poses differ by more than 1e-6")


if __name__ == "__main__":
    sys.exit(main())
