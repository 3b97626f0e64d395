"""Reference numbers for the PyTorch port's chip smoke (``chip_smoke.py``
phases 28 to 44), computed once with the JAX package on the CPU in f64 on
the very graphs the smoke builds:

  28  chi2 of sphere2500 (``se3_sphere(2500, seed=0)``) and of bench config
      2's graph (``se2_manhattan(3500, seed=1)`` through ``write_g2o`` /
      ``read_g2o``) at the 'odometry', 'spanning_tree' and 'chordal' inits,
      the last with its stages solved as the reference's ``_solve_stage``
      declares (the port's policy) and as the released ``chordal_init``
      solves them (``solve_auto`` at every size);
  29  ``solve_gnc`` (TLS, ``Options(method="lm")``) on sphere2500 with 100
      wrong loop closures (``with_outliers(..., 100, magnitude=2.0,
      seed=1)``): final chi2, outer iterations, the rejected edges;
  30  ``switchable_pose_graph(with_outliers(<config 2's graph>, 100,
      seed=2), xi=5.0)`` solved by LM 60: chi2, iterations, the switches
      below 0.5;
  31  ``vio_graph`` on ``imu_circle(400, kf_dt=0.5, imu_rate=200)`` with
      ``examples/vio.py``'s noise and biases, written as EuRoC files, read
      back and segmented at the keyframe times (intervals padded with
      ``dt = 0`` samples to one length: an exact no-op of the recursion),
      solved by LM 60: chi2 and LM iterations;
  32  ``examples/vio_sliding_window.py``'s estimator (window 5, LM 25 a
      keyframe, ``marginalize`` of the oldest (pose, velocity, bias)
      triple) over phase 31's trajectory, fed straight from the generator:
      the newest pose's error, chi2, LM iterations and gyro-bias error at
      every keyframe (arrays), the final bias estimate;
  33  ``FixedLagSmoother("se3", window=100, gn_iters=3,
      anchor_sqrt_info=1e4)`` streamed over sphere2500 with the feed of
      ``tests/test_fixed_lag.py``: every pose as it leaves the window and
      the last window, in f64 (and the f32 run's gap to it);
  34  ``FixedLagLandmarkSmoother("se2", obs_kind="bearing_range_se2",
      window=20, lm_slots=64, gn_iters=3)`` streamed over bench config 8's
      graph: as phase 33, plus the landmarks retired, in order, with their
      values at retirement;
  35  ``IncrementalSmoother("se2")`` over bench config 2's stream, an
      ``update()`` after every 250 new poses, then
      ``marginalize_oldest(keep_last=500)`` and one more ``update()``: the
      chi2 and LM iterations of every update, ``compiles``, the final poses;
  36  ``solve_schur_sqrt`` (LM 50) on the monocular low-parallax BAL graph
      of Ladybug-49's size (``synthetic_bal(49, 7000, seed=0,
      cam_cluster=0.05)``, perturbed) in f64, and the f32 solves'
      (``solve_schur_sqrt`` and ``solve_schur(mode="dense")``) gaps to it.

  37  sphere2500 (``se3_sphere(2500, seed=0)``) at its ground-truth poses:
      the selected-inverse marginals (``sparse_chol``, leaf 32) of 64
      evenly spaced poses, the cross blocks of 16 odometry pairs, log det H;
  38  ``bench/covariance_bench.py``'s graph, ``se2_manhattan(3500,
      seed=1)``, at its ground-truth poses: the marginals of 16 evenly
      spaced poses by the selected inverse, log det H;
  39  Venice-mini (``ba_synthetic(300, 60000, obs_per_pt=6, seed=0)``) at
      its ground-truth values: the marginals of 16 evenly spaced cameras and
      of 16 evenly spaced points (``method="sparse"``);
  41  ``IncrementalSmoother.pose_marginals`` in its three branches: phase
      35's stream before and after ``marginalize_oldest(keep_last=500)``
      (16 evenly spaced poses each), and the landmark stream of
      ``tests/test_torch_incremental.py`` (``landmark_slam_2d(22, 12)``,
      bearing-range, LM 15, an update every 6 poses) without and with
      ``keep_window=10``;
  42  ``solve_batched`` (LM 50) of chip phase 17's fleet of 16
      ``se2_loop(100, 12, seed=s)`` graphs under ``TDistributionLoss()``,
      and of the L2 fleet by dogleg: each problem's chi2;
  44  ``solve_implicit`` with ``tests/test_diff.py``'s options on
      ``se2_manhattan(3500, seed=1)`` (bench config 2's size, 10,500 dof):
      the objective (the last pose's translation summed plus 0.1 chi2),
      chi2, the norm of its gradient with respect to every ``T_obs`` and
      the gradient's 64 largest entries (flat index, value).
  46  dense RGB-D VO at VGA (``bench/vo_overlap.py``'s 40 frames, 4
      levels, ``keyframe_trans_thresh=1e9``): the trajectory of ``track``
      frame by frame, and of ``track_batch`` at K = 16 on
      ``bench/vo_batch.py``'s protocol (the first frame tracked, then 32
      frames in two batches);
  47  dense stereo VO at VGA with the on-device block matcher
      (``matcher="tpu"``, 128 disparities) on
      ``pyslam_tpu_torch.testing.vo_stereo_frames`` (16 uint8 stereo
      frames along ``vo_frames``' path of a plane textured with the
      reference matcher test's noise): the keyframe's disparity map, the
      trajectory, and the trajectory of ``affine_illumination=True``
      through an exposure ramp (frame k at gain 1 + 0.05 k, bias 0.02 k),
      its keyframe on the matcher's map too;
  48  ``examples/stereo_slam.py``'s pipeline (40 frames, 4,000 points) on
      ``pyslam_tpu_torch.testing.stereo_slam_world``'s data in float32,
      run as the example runs (x64 off): the ATE after the RANSAC odometry,
      the pose graph and joint SLAM, and every RANSAC call's samples (they
      depend on the match count alone: ``PRNGKey(0)`` every call), which
      the port is given to reproduce the reference's hypotheses.

  f32 the f32 solves of both packages on the CPU, the JAX package's and the
      port's (``device="cpu"``) on the same graphs: sphere2500 through
      ``solve_ell`` with chip phase 4's settings (LM 30, stop at a cost
      decrease above 0.999, PCG 3e-6 / 120) and bench config 4
      (``ba_synthetic(49, 7000, seed=0)``) through
      ``solve_schur(mode="pcg")`` with phase 10's (LM 25, PCG 1e-4 / 30):
      LM iterations, stop code, chi2, and the CG iterations of every linear
      solve (each package's PCG wrapped to record them; the JAX package's
      by ``jax.debug.callback``); the same solves in f64 beside them.
      Printed only; nothing goes to the npz.

Phases 37 to 39 take the ground truth because it is an estimate both
packages hold bit for bit; the chip smoke also checks the port's methods
against each other at its own converged estimates.

Scalars print as JSON on the last line; the arrays of phases 32 to 35,
37 to 42, 44 and 46 to 48 (per keyframe, the poses, the covariance blocks,
the gradient, the trajectories, the disparity map) go to
``chip_smoke_refs.npz`` beside ``chip_smoke.py``, which loads them.  The port never imports this script; its numbers are constants in
``chip_smoke.py``.  Run from the repository root (minutes; phase 30 holds a
dense f64 H of 11,008 x 11,008, about 1 GB; phase 35 one of 14,130 x
14,130, 1.6 GB):

    python scripts/torch_port_refs.py [--phases 28,29,30,31,32,33,34,35,36]
    python scripts/torch_port_refs.py --phases 37,38,39,41,42
    python scripts/torch_port_refs.py --phases 44
    python scripts/torch_port_refs.py --phases 46,47,48
    python scripts/torch_port_refs.py --phases f32
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from pyslam_tpu import imu
from pyslam_tpu.graph import build
from pyslam_tpu.io import euroc, g2o, synth
from pyslam_tpu.lie import se3
from pyslam_tpu.solver import Options, solve, solve_gnc


def m3500():
    """Bench config 2's graph: se2_manhattan(3500, seed=1) through the g2o
    writer and reader."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m3500.g2o")
        g2o.write_g2o(path, synth.se2_manhattan(n_poses=3500, seed=1))
        return g2o.read_g2o(path)


class declared_stage_solver:
    """Within this context the reference's ``chordal_init`` solves its stages
    as its own ``_solve_stage`` declares (``pyslam_tpu/graph/initialize.py``:
    ``solve_auto`` up to 12,000 dof, ``solve_ell(pcg_rtol=1e-6,
    pcg_max_iters=250)`` above), the policy the port follows; as released,
    the reference calls ``solve_auto`` for both stages at every size."""

    def __enter__(self):
        import pyslam_tpu.solver as jsolver
        from pyslam_tpu.solver.bcsr import solve_ell

        self.jsolver, self.solve_auto = jsolver, jsolver.solve_auto

        def stage(g, opts):
            if g.total_dof <= 12000:
                return self.solve_auto(g, opts)
            return solve_ell(g, opts, pcg_rtol=1e-6, pcg_max_iters=250)

        jsolver.solve_auto = stage
        return self

    def __exit__(self, *exc):
        self.jsolver.solve_auto = self.solve_auto
        return False


def phase28():
    """'chordal' under the declared stage solver (the gate), 'chordal_as_released'
    as the reference's ``chordal_init`` runs it."""
    out = {}
    for name, data in (("sphere2500", synth.se3_sphere(n_poses=2500, seed=0)), ("m3500", m3500())):
        for init in ("odometry", "spanning_tree", "chordal", "chordal_as_released"):
            t0 = time.perf_counter()
            if init == "chordal":
                with declared_stage_solver():
                    g = build.pose_graph(data, dtype=jnp.float64, init="chordal")
            else:
                g = build.pose_graph(data, dtype=jnp.float64, init=init.removesuffix("_as_released"))
            chi2 = float(g.chi2())
            out[f"{name}_{init}"] = dict(chi2=chi2, seconds=time.perf_counter() - t0)
            print(f"28 {name} init={init}: chi2 {chi2!r} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def phase29():
    data, planted = synth.with_outliers(synth.se3_sphere(n_poses=2500, seed=0), 100, magnitude=2.0, seed=1)
    g = build.pose_graph(data, dtype=jnp.float64)
    t0 = time.perf_counter()
    _, info = solve_gnc(g, Options(method="lm"))
    (mask,) = info.inlier_masks
    rejected = np.nonzero(~mask)[0]
    out = dict(chi2=float(info.chi2), outer_iters=int(info.outer_iters), edges=int(mask.size),
               rejected=[int(k) for k in rejected], planted_rejected=int((~mask[planted]).sum()),
               seconds=time.perf_counter() - t0)
    print(f"29 gnc: chi2 {out['chi2']!r}, outer {out['outer_iters']}, rejected {len(rejected)} "
          f"({out['planted_rejected']} of 100 planted), {out['seconds']:.1f} s", flush=True)
    return out


def phase30():
    poisoned, _ = synth.with_outliers(m3500(), 100, seed=2)
    g = build.switchable_pose_graph(poisoned, dtype=jnp.float64, xi=5.0)
    t0 = time.perf_counter()
    solved, info = solve(g, Options(method="lm", max_iters=60))
    s = np.asarray(solved.blocks["switches"].values)[:, 0]
    out = dict(chi2=float(info.chi2), iterations=int(info.iterations), status=int(info.status),
               switches=int(s.size), below_half=[int(k) for k in np.nonzero(s < 0.5)[0]],
               planted_max=float(s[-100:].max()), true_min=float(s[:-100].min()), seconds=time.perf_counter() - t0)
    print(f"30 switchable: chi2 {out['chi2']!r}, iterations {out['iterations']}, status {out['status']}, "
          f"{len(out['below_half'])} switches below 0.5, planted max {out['planted_max']!r}, true min "
          f"{out['true_min']!r}, {out['seconds']:.1f} s", flush=True)
    return out


def vio_inputs(exp, n_keyframes=400):
    """(ImuData, T_prior) of phase 31: ``examples/vio.py``'s trajectory at
    400 keyframes; ``exp`` is an SE(3) exponential on a (6,) numpy vector."""
    b_g = np.array([0.002, -0.001, 0.003])
    b_a = np.array([0.05, -0.03, 0.02])
    d = synth.imu_circle(n_keyframes=n_keyframes, kf_dt=0.5, imu_rate=200, gyro_noise=1.7e-4 * np.sqrt(200),
                         accel_noise=2e-3 * np.sqrt(200), b_gyro=b_g, b_accel=b_a, seed=0)
    rng = np.random.default_rng(1)
    T_prior = np.stack([exp(rng.normal(size=6) * 2e-3) @ d.T_gt[i] for i in range(d.T_gt.shape[0])])
    return d, T_prior


def euroc_round_trip(d, folder):
    """Write the sequence as EuRoC files, read it back, segment the IMU
    stream at the keyframe times: (t_kf, T_gt, v_gt, segments)."""
    n_int, K = d.dts.shape
    t = np.arange(n_int * K) * d.dts[0, 0]
    t_kf = np.arange(d.T_gt.shape[0]) * (K * d.dts[0, 0])
    imu_path, gt_path = os.path.join(folder, "imu0.csv"), os.path.join(folder, "gt.csv")
    euroc.write_imu(imu_path, t, d.omega.reshape(-1, 3), d.accel.reshape(-1, 3))
    euroc.write_groundtruth(gt_path, t_kf, d.T_gt, d.v_gt, b_gyro=d.b_gyro, b_accel=d.b_accel)
    origin = euroc.first_timestamp_ns(imu_path)
    t2, w2, a2 = euroc.read_imu(imu_path, origin_ns=origin)
    t_kf2, T2, v2, _, _ = euroc.read_groundtruth(gt_path, origin_ns=origin)
    return t_kf2, T2, v2, euroc.segment_imu(t2, w2, a2, t_kf2)


def phase31():
    d, T_prior = vio_inputs(lambda v: np.asarray(se3.exp(jnp.asarray(v))))
    with tempfile.TemporaryDirectory() as td:
        _, T2, v2, segs = euroc_round_trip(d, td)
    lengths = [len(s[2]) for s in segs]
    Kmax = max(lengths)
    n = T2.shape[0]
    pad = np.zeros((n - 1, Kmax, 3)), np.zeros((n - 1, Kmax, 3)), np.zeros((n - 1, Kmax))
    for i, (w, a, dt) in enumerate(segs):
        pad[0][i, : len(dt)], pad[1][i, : len(dt)], pad[2][i, : len(dt)] = w, a, dt
    data = synth.ImuData(T2, v2, d.b_gyro, d.b_accel, pad[0], pad[1], pad[2], d.gravity)
    t0 = time.perf_counter()
    g = imu.vio_graph(data, T_prior, np.diag([1 / 2e-3] * 6), T_init=T_prior, v_init=np.zeros((n, 3)),
                      b_init=np.zeros((n, 6)))
    chi2_0 = float(g.chi2())
    solved, info = solve(g, Options(method="lm", max_iters=60))
    v_est = np.asarray(solved.blocks["vels"].values)
    b_est = np.asarray(solved.blocks["biases"].values).mean(0)
    out = dict(chi2_init=chi2_0, chi2=float(info.chi2), iterations=int(info.iterations), status=int(info.status),
               interval_lengths=sorted(set(lengths)), v_err=float(np.abs(v_est - d.v_gt).max()),
               bg_err=float(np.abs(b_est[:3] - d.b_gyro).max()), seconds=time.perf_counter() - t0)
    print(f"31 vio: chi2 {chi2_0!r} -> {out['chi2']!r}, iterations {out['iterations']}, status {out['status']}, "
          f"interval lengths {out['interval_lengths']}, velocity error {out['v_err']!r}, gyro bias error "
          f"{out['bg_err']!r}, {out['seconds']:.1f} s", flush=True)
    return out


def phase32():
    """``examples/vio_sliding_window.py`` over phase 31's trajectory: each
    keyframe appends its (pose, velocity, bias) triple, the IMU factor of
    its interval, a bias walk and a pose prior, runs LM 25, and past a
    window of 5 marginalizes the oldest triple."""
    from pyslam_tpu.graph import FactorBatch, FactorGraph, VariableBlock, marginalize
    from pyslam_tpu.losses import L2Loss

    d, T_meas = vio_inputs(lambda v: np.asarray(se3.exp(jnp.asarray(v))))
    n, f64, z3 = d.T_gt.shape[0], jnp.float64, np.zeros(3)
    Spp = jnp.asarray(np.diag([1 / 2e-3] * 6))
    walk = jnp.asarray(np.eye(6) / (1e-3 * np.sqrt(0.5)), f64)[None]

    def pose_prior(k_local, T_obs):
        return FactorBatch.create("prior_se3", slots=("poses",), indices=(np.array([k_local], np.int32),),
                                  data={"T_obs": jnp.asarray(T_obs, f64)[None], "sqrt_info": Spp[None]}, loss=L2Loss())

    def append(block, value):
        return VariableBlock(block.kind, jnp.concatenate([block.values, jnp.asarray(value)[None]], axis=0),
                             jnp.concatenate([block.const_mask, jnp.zeros(1, bool)]))

    t0 = time.perf_counter()
    pims = [imu.preintegrate(d.omega[k], d.accel[k], d.dts[k], z3, z3) for k in range(n - 1)]
    t_pre = time.perf_counter() - t0
    blocks = {"poses": VariableBlock.create("se3", jnp.asarray(T_meas[:1], f64)),
              "vels": VariableBlock.create("euclidean", jnp.zeros((1, 3), f64)),
              "biases": VariableBlock.create("euclidean", jnp.zeros((1, 6), f64))}
    g = FactorGraph(blocks, [pose_prior(0, T_meas[0])])
    errs, chi2s, iters, bg_errs = [], [], [], []
    t0 = time.perf_counter()
    for k in range(1, n):
        pim = pims[k - 1]
        imu_data = {key: jnp.asarray(np.asarray(getattr(pim, key)), f64)[None]
                    for key in ["dR", "dv", "dp", "J_Rg", "J_vg", "J_va", "J_pg", "J_pa", "b_lin", "dt"]}
        imu_data["sqrt_info"] = jnp.asarray(imu.sqrt_info_of(pim), f64)[None]
        imu_data["gravity"] = jnp.asarray(d.gravity, f64)[None]
        w = g.blocks["poses"].n
        blocks = dict(g.blocks)
        blocks["poses"] = append(blocks["poses"], jnp.asarray(T_meas[k], f64))
        blocks["vels"] = append(blocks["vels"], blocks["vels"].values[-1])
        blocks["biases"] = append(blocks["biases"], blocks["biases"].values[-1])
        batches = list(g.batches) + [
            FactorBatch.create("imu_preintegrated", slots=("poses", "poses", "vels", "vels", "biases"),
                               indices=tuple(np.array([i], np.int32) for i in (w - 1, w, w - 1, w, w - 1)),
                               data=imu_data, loss=L2Loss()),
            FactorBatch.create("between_euclidean", slots=("biases", "biases"),
                               indices=(np.array([w - 1], np.int32), np.array([w], np.int32)),
                               data={"delta": jnp.zeros((1, 6), f64), "sqrt_info": walk}, loss=L2Loss()),
            pose_prior(w, T_meas[k])]
        g, info = solve(FactorGraph(blocks, batches), Options(method="lm", max_iters=25))
        if g.blocks["poses"].n > 5:
            g = marginalize(g, {"poses": [0], "vels": [0], "biases": [0]})
        T_new = g.blocks["poses"].values[-1]
        errs.append(float(jnp.linalg.norm(se3.log(jnp.asarray(d.T_gt[k], f64) @ se3.inv(T_new)))))
        chi2s.append(float(info.chi2))
        iters.append(int(info.iterations))
        bg_errs.append(float(np.abs(np.asarray(g.blocks["biases"].values).mean(0)[:3] - d.b_gyro).max()))
    b_est = np.asarray(g.blocks["biases"].values).mean(0)
    out = dict(errs=errs, chi2=chi2s, iterations=iters, b_est=b_est.tolist(),
               bg_err=float(np.abs(b_est[:3] - d.b_gyro).max()), preintegration_seconds=t_pre,
               seconds=time.perf_counter() - t0)
    print(f"32 vio window: {n - 1} keyframes, newest-pose error max {max(errs)!r} (from the 6th {max(errs[5:])!r}), "
          f"gyro bias error {out['bg_err']!r}, LM iterations {sum(iters)}, {out['seconds']:.1f} s "
          f"(+ {t_pre:.1f} s preintegration)", flush=True)
    return out, {"p32_errs": np.asarray(errs), "p32_chi2": np.asarray(chi2s), "p32_iterations": np.asarray(iters),
                 "p32_bg_errs": np.asarray(bg_errs)}


# The feeds below are the port's (``pyslam_tpu_torch/testing.py``: the same
# calls in the same order); they are repeated here so that the reference's
# numbers come from a process that loads nothing of the port.


def drive_fixed_lag(sm, data, n):
    """The feed of ``tests/test_fixed_lag.py``: odometry, then every loop
    closure ending at the new pose whose older pose is still in the window;
    ``update()`` after each pose.  Returns the poses as they leave the
    window (by absolute id) and the last window."""
    by_j = {}
    for k, (i, j) in enumerate(zip(map(int, data.edges_i), map(int, data.edges_j))):
        by_j.setdefault(j, []).append((k, i))
    chain = {j: k for j, ks in by_j.items() for k, i in ks if i == j - 1}
    left = {}
    sm.add_pose(data.T_init[0])
    est = None
    for t in range(1, n):
        if sm.count == sm.window:
            left[sm.first_id] = est[0]
        k = chain[t]
        sm.add_odometry(data.T_meas[k], data.sqrt_info[k])
        for k2, i in by_j.get(t, []):
            if i != t - 1 and i >= sm.first_id:
                sm.add_factor(i, t, data.T_meas[k2], data.sqrt_info[k2])
        est = sm.update()
    return left, est


def drive_fixed_lag_landmarks(sm, data, n):
    """The feed of ``tests/test_fixed_lag.py``'s landmark windows: each
    pose's observations in order, a landmark added at its first
    observation (``lm_init``), observations of an evicted landmark
    dropped; ``update()`` after each pose.  Returns (poses leaving the
    window, the last window, the retirements (id, value) in order)."""
    chain = {int(j): k for k, (i, j) in enumerate(zip(data.edges_i, data.edges_j)) if int(i) == int(j) - 1}
    obs_by_pose = {}
    for k, pi in enumerate(data.obs_pose):
        obs_by_pose.setdefault(int(pi), []).append(k)
    lm_added, retired, left = {}, [], {}
    retire = sm.retire_landmark

    def recorded(lm_id):
        retired.append((lm_id, np.asarray(sm.landmark(lm_id))))
        retire(lm_id)

    sm.retire_landmark = recorded

    def feed(t):
        for k in obs_by_pose.get(t, []):
            lj = int(data.obs_lm[k])
            if lj not in lm_added:
                lm_added[lj] = sm.add_landmark(data.lm_init[lj])
            if lm_added[lj] in sm._lm_id2slot:
                sm.add_observation(t, lm_added[lj], data.obs[k], data.obs_sqrt_info[k])

    sm.add_pose(data.T_init[0])
    feed(0)
    est = None
    for t in range(1, n):
        if sm.count == sm.window:
            left[sm.first_id] = est[0]
        sm.add_odometry(data.T_meas[chain[t]], data.sqrt_info[chain[t]])
        feed(t)
        est = sm.update()
    return left, est, retired


def _poses_array(left, last, n):
    out = np.stack([left[i] for i in range(n - len(last))] + list(last))
    assert out.shape[0] == n
    return out


def phase33():
    from pyslam_tpu.solver.fixed_lag import FixedLagSmoother

    data = synth.se3_sphere(n_poses=2500, seed=0)
    out, arrays = {}, {}
    for dtype in (jnp.float64, jnp.float32):
        sm = FixedLagSmoother(window=100, kind="se3", gn_iters=3, anchor_sqrt_info=1e4, dtype=dtype)
        t0 = time.perf_counter()
        left, last = drive_fixed_lag(sm, data, 2500)
        arrays[dtype] = _poses_array(left, last, 2500).astype(np.float64)
        out[f"seconds_{np.dtype(dtype).name}"] = time.perf_counter() - t0
    out["f32_gap"] = float(np.abs(arrays[jnp.float32] - arrays[jnp.float64]).max())
    out["edges"] = int(len(data.edges_i))
    print(f"33 fixed-lag sphere2500: f32 gap {out['f32_gap']!r}, {out['seconds_float64']:.1f} s f64, "
          f"{out['seconds_float32']:.1f} s f32", flush=True)
    return out, {"p33_poses": arrays[jnp.float64]}


def config8_data():
    return synth.landmark_slam_2d(n_poses=800, n_landmarks=250, max_range=10.0, obs_type="bearing_range",
                                  odo_rot_std=0.005, seed=0)


def phase34():
    from pyslam_tpu.solver.fixed_lag import FixedLagLandmarkSmoother

    data = config8_data()
    out, arrays, retired = {}, {}, {}
    for dtype in (jnp.float64, jnp.float32):
        sm = FixedLagLandmarkSmoother(window=20, lm_slots=64, obs_kind="bearing_range_se2", kind="se2", gn_iters=3,
                                      dtype=dtype)
        t0 = time.perf_counter()
        left, last, ret = drive_fixed_lag_landmarks(sm, data, 800)
        arrays[dtype] = _poses_array(left, last, 800).astype(np.float64)
        retired[dtype] = ret
        out[f"seconds_{np.dtype(dtype).name}"] = time.perf_counter() - t0
        if dtype is jnp.float64:
            live = sm.landmarks()
            out["live_landmarks"] = sorted(int(i) for i in live)
            lm_live = np.stack([live[i] for i in out["live_landmarks"]]).astype(np.float64)
    out["retired"] = [int(i) for i, _ in retired[jnp.float64]]
    out["retired_f32_same"] = out["retired"] == [int(i) for i, _ in retired[jnp.float32]]
    out["f32_gap"] = float(np.abs(arrays[jnp.float32] - arrays[jnp.float64]).max())
    print(f"34 fixed-lag landmarks config 8: {len(out['retired'])} retired, f32 gap {out['f32_gap']!r} (same "
          f"retirements {out['retired_f32_same']}), {out['seconds_float64']:.1f} s f64", flush=True)
    ret_vals = np.stack([np.asarray(v, np.float64) for _, v in retired[jnp.float64]])
    return out, {"p34_poses": arrays[jnp.float64], "p34_retired_values": ret_vals, "p34_live_landmarks": lm_live}


def drive_incremental(sm, data, every=250):
    """Bench config 2's stream into an ``IncrementalSmoother``: poses at the
    odometry prediction from the last estimate, each loop closure once both
    its poses exist; ``update()`` after every ``every`` new poses.  Returns
    the (chi2, LM iterations) of each update."""
    n = data.T_init.shape[0]
    n_odo = n - 1
    assert (np.asarray(data.edges_i[:n_odo]) == np.arange(n_odo)).all()
    loops = list(range(n_odo, len(data.edges_i)))
    out = []
    for upto in range(every, n + 1, every):
        while sm.n < upto:
            i = sm.n
            if i == 0:
                sm.add_pose(data.T_init[0])
            else:
                sm.add_pose(data.T_meas[i - 1] @ sm.poses()[i - 1])
                sm.add_between(i - 1, i, data.T_meas[i - 1], data.sqrt_info[i - 1])
        later = []
        for e in loops:
            i, j = int(data.edges_i[e]), int(data.edges_j[e])
            if max(i, j) < upto:
                sm.add_between(i, j, data.T_meas[e], data.sqrt_info[e])
            else:
                later.append(e)
        loops = later
        _, info = sm.update()
        out.append((float(info.chi2), int(info.iterations)))
    return out


def phase35():
    from pyslam_tpu.solver.incremental import IncrementalSmoother

    data = m3500()
    sm = IncrementalSmoother(kind="se2")
    t0 = time.perf_counter()
    ups = drive_incremental(sm, data)
    sm.marginalize_oldest(keep_last=500)
    _, info = sm.update()
    ups.append((float(info.chi2), int(info.iterations)))
    out = dict(chi2=[c for c, _ in ups], iterations=[i for _, i in ups], compiles=sm.compiles, n_final=sm.n,
               seconds=time.perf_counter() - t0)
    print(f"35 incremental m3500: {len(ups)} updates, iterations {out['iterations']}, compiles {sm.compiles}, "
          f"{out['seconds']:.1f} s", flush=True)
    return out, {"p35_poses": np.asarray(sm.poses(), np.float64)}


def phase36():
    from pyslam_tpu.io import bal
    from pyslam_tpu.solver import route_auto, solve_schur
    from pyslam_tpu.solver.schur_sqrt import solve_schur_sqrt

    data = bal.perturbed(bal.synthetic_bal(49, 7000, seed=0, cam_cluster=0.05))
    opts = Options(method="lm", max_iters=50)
    g64 = build.bal_graph(data, dtype=jnp.float64)
    g32 = build.bal_graph(data, dtype=jnp.float32)
    t0 = time.perf_counter()
    _, info = solve_schur_sqrt(g64, opts)
    t64 = time.perf_counter() - t0
    chi2 = float(info.chi2)
    _, i_sqrt32 = solve_schur_sqrt(g32, opts)
    _, i_dense32 = solve_schur(g32, opts, mode="dense")
    out = dict(route_f32=route_auto(g32), chi2=chi2, iterations=int(info.iterations), status=int(info.status),
               observations=int(g64.batches[0].n), cost_history=[float(c) for c in np.asarray(info.cost_history)
                                                                  if np.isfinite(c)],
               gap_sqrt_f32=abs(float(i_sqrt32.chi2) - chi2) / chi2,
               gap_dense_f32=abs(float(i_dense32.chi2) - chi2) / chi2, seconds_f64=t64)
    print(f"36 schur_sqrt ladybug-49 mono: route(f32) {out['route_f32']}, chi2 {chi2!r}, iterations "
          f"{out['iterations']}, f32 gaps sqrt {out['gap_sqrt_f32']!r} dense {out['gap_dense_f32']!r}", flush=True)
    return out


def _spaced(n, k):
    return np.linspace(0, n - 1, k).astype(np.int64)


def _at_truth(g, **values):
    """The graph with its blocks set to the given (ground-truth) values."""
    from pyslam_tpu.graph.core import VariableBlock

    blocks = dict(g.blocks)
    for name, v in values.items():
        b = blocks[name]
        blocks[name] = VariableBlock.create(b.kind, jnp.asarray(v, b.values.dtype), b.const_mask)
    return g.with_values(blocks)


def _selinv(g, pairs=None):
    """(symmetrized marginals of every variable, pair blocks, log det H) of a
    single-block graph through the reference's sparse_chol, jitted."""
    from pyslam_tpu.solver import bcsr
    from pyslam_tpu.solver import sparse_chol as sc

    plan = sc.build_chol_plan(g)
    sc._device_waves(plan)  # the tables as executable parameters, not constants
    He, _, _ = jax.jit(lambda gg: bcsr.assemble_ell(gg, plan.ell))(g)
    factors = jax.jit(lambda H: sc._factorize(plan, H))(He)
    if pairs is None:
        diag, blocks = jax.jit(lambda f: sc.selected_inverse_marginals(plan, f))(factors), None
    else:
        diag, blocks = jax.jit(lambda f: sc.selected_inverse_marginals(plan, f, pairs=pairs))(factors)
    diag = np.asarray(diag)
    logdet = float(jax.jit(lambda f: sc.factor_logdet(plan, f))(factors))
    return 0.5 * (diag + diag.transpose(0, 2, 1)), (None if blocks is None else np.asarray(blocks)), logdet


def phase37():
    data = synth.se3_sphere(n_poses=2500, seed=0)
    g = _at_truth(build.pose_graph(data, dtype=jnp.float64), poses=data.T_gt)
    n = len(data.T_gt)
    idx = _spaced(n, 64)
    pairs = np.stack([_spaced(n - 1, 16), _spaced(n - 1, 16) + 1], 1)
    t0 = time.perf_counter()
    marg, blocks, logdet = _selinv(g, pairs=[tuple(p) for p in pairs])
    out = dict(logdet=logdet, seconds=time.perf_counter() - t0)
    print(f"37 sphere2500 selected inverse at the truth: log det {logdet!r}, {out['seconds']:.1f} s", flush=True)
    return out, {"p37_idx": idx, "p37_marg": marg[idx], "p37_pairs": pairs, "p37_pair_blocks": blocks,
                 "p37_logdet": np.float64(logdet)}


def phase38():
    data = synth.se2_manhattan(n_poses=3500, seed=1)
    g = _at_truth(build.pose_graph(data, dtype=jnp.float64), poses=data.T_gt)
    idx = _spaced(len(data.T_gt), 16)
    t0 = time.perf_counter()
    marg, _, logdet = _selinv(g)
    out = dict(logdet=logdet, seconds=time.perf_counter() - t0)
    print(f"38 M3500 selected inverse at the truth: log det {logdet!r}, {out['seconds']:.1f} s", flush=True)
    return out, {"p38_idx": idx, "p38_marg": marg[idx], "p38_logdet": np.float64(logdet)}


def phase39():
    from pyslam_tpu.solver import landmark_marginal_covariances, pose_marginal_covariances

    data = synth.ba_synthetic(n_cams=300, n_pts=60000, obs_per_pt=6, seed=0)
    g = _at_truth(build.ba_graph(data, dtype=jnp.float64), poses=data.T_gt, landmarks=data.pts_gt)
    cams, pts = _spaced(len(data.T_gt), 16), _spaced(len(data.pts_gt), 16)
    t0 = time.perf_counter()
    pose = np.asarray(pose_marginal_covariances(g, indices=cams, method="sparse"))
    lms = np.asarray(landmark_marginal_covariances(g, pts, method="sparse"))
    out = dict(seconds=time.perf_counter() - t0)
    print(f"39 Venice-mini marginals at the truth: {out['seconds']:.1f} s", flush=True)
    return out, {"p39_cams": cams, "p39_pose_marg": pose, "p39_pts": pts, "p39_lm_marg": lms}


def phase41():
    from pyslam_tpu.solver.incremental import IncrementalSmoother
    from pyslam_tpu_torch.testing import drive_incremental, drive_incremental_landmarks

    t0 = time.perf_counter()
    sm = IncrementalSmoother(kind="se2")
    drive_incremental(sm, m3500(), every=250)
    idx = _spaced(sm.n, 16)
    before = np.asarray(sm.pose_marginals())[idx]
    sm.marginalize_oldest(keep_last=500)
    sm.update()
    idx_after = _spaced(sm.n, 16)
    after = np.asarray(sm.pose_marginals())[idx_after]
    arrays = {"p41_idx": idx, "p41_before": before, "p41_idx_after": idx_after, "p41_after": after}
    data = synth.landmark_slam_2d(n_poses=22, n_landmarks=12, max_range=9.0, obs_type="bearing_range", seed=8)
    for key, keep in (("p41_schur", None), ("p41_dense", 10)):
        lsm = IncrementalSmoother(kind="se2", obs_kind="bearing_range_se2", options=Options(method="lm", max_iters=15))
        drive_incremental_landmarks(lsm, data, 6, keep)
        arrays[key] = np.asarray(lsm.pose_marginals())
    out = dict(n_after=int(sm.n), seconds=time.perf_counter() - t0)
    print(f"41 pose_marginals: three branches, {out['seconds']:.1f} s", flush=True)
    return out, arrays


def phase42():
    from pyslam_tpu.losses import TDistributionLoss
    from pyslam_tpu.solver import solve_batched

    loops = [synth.se2_loop(n_poses=100, n_loops=12, seed=s) for s in range(16)]
    t0 = time.perf_counter()
    fleet_t = [build.pose_graph(d, loss=TDistributionLoss(), dtype=jnp.float64) for d in loops]
    _, chi2_t = solve_batched(fleet_t, Options(method="lm", max_iters=50))
    fleet = [build.pose_graph(d, dtype=jnp.float64) for d in loops]
    _, chi2_d = solve_batched(fleet, Options(method="dogleg", max_iters=50))
    out = dict(seconds=time.perf_counter() - t0)
    print(f"42 solve_batched: t-distribution and dogleg fleets, {out['seconds']:.1f} s", flush=True)
    return out, {"p42_chi2_t": np.asarray(chi2_t), "p42_chi2_dogleg": np.asarray(chi2_d)}


def phase44():
    """``solve_implicit`` (``tests/test_diff.py``'s options) on bench config
    2's size, se2_manhattan(3500, seed=1) in f64: the gradient of the last
    pose's translation summed plus 0.1 chi2 with respect to every T_obs."""
    from pyslam_tpu.graph.core import FactorBatch, FactorGraph
    from pyslam_tpu.solver.diff import solve_implicit

    opts = Options(method="lm", max_iters=60, min_cost_decrease=1 - 1e-13, min_update_norm=1e-14)
    g = build.pose_graph(synth.se2_manhattan(n_poses=3500, seed=1), dtype=jnp.float64)
    fb = g.batches[0]

    def objective(T_obs):
        fb2 = FactorBatch(fb.kind, fb.slots, fb.indices, {**fb.data, "T_obs": T_obs}, fb.loss, fb.weight)
        values, chi2 = solve_implicit(FactorGraph(g.blocks, [fb2]), opts)
        return jnp.sum(values["poses"][-1, :2, 2]) + 0.1 * chi2, chi2

    t0 = time.perf_counter()
    (value, chi2), grad = jax.value_and_grad(objective, has_aux=True)(fb.data["T_obs"])
    grad = np.asarray(grad)
    top = np.argsort(-np.abs(grad).ravel(), kind="stable")[:64]
    out = dict(value=float(value), chi2=float(chi2), grad_norm=float(np.linalg.norm(grad)),
               seconds=time.perf_counter() - t0)
    print(f"44 solve_implicit M3500: objective {out['value']!r}, chi2 {out['chi2']!r}, |grad| {out['grad_norm']!r}, "
          f"{out['seconds']:.1f} s", flush=True)
    return out, {"p44_value": np.float64(value), "p44_chi2": np.float64(chi2),
                 "p44_grad_norm": np.float64(out["grad_norm"]), "p44_top_idx": top, "p44_top_vals": grad.ravel()[top]}


def phase46():
    """VGA RGB-D VO: ``track`` frame by frame and ``track_batch`` at K = 16."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench"))
    from vo_overlap import CAM, make_frames

    from pyslam_tpu.pipelines import DenseRGBDPipeline
    from pyslam_tpu.sensors import RGBDCamera

    frames = make_frames(40)
    t0 = time.perf_counter()
    seq = DenseRGBDPipeline(RGBDCamera(**CAM), pyrlevels=4, keyframe_trans_thresh=1e9)
    for im, depth in frames:
        seq.track(im, depth)
    bat = DenseRGBDPipeline(RGBDCamera(**CAM), pyrlevels=4, keyframe_trans_thresh=1e9)
    bat.track(*frames[0])
    ims = [im for im, _ in frames[1:]]
    for s in range(0, (len(ims) // 16) * 16, 16):
        bat.track_batch(ims[s: s + 16])
    out = dict(seconds=time.perf_counter() - t0, keyframes=len(seq.keyframes))
    print(f"46 VGA RGB-D VO: {len(seq.T_c_w)} frames, batch {len(bat.T_c_w)}, {out['seconds']:.1f} s", flush=True)
    return out, {"p46_seq": np.stack(seq.T_c_w), "p46_batch": np.stack(bat.T_c_w)}


def phase47():
    """VGA stereo VO with the on-device block matcher, then the affine
    kernel through an exposure ramp."""
    from pyslam_tpu.pipelines import DenseStereoPipeline
    from pyslam_tpu.pipelines.keyframes import compute_disparity
    from pyslam_tpu.sensors import StereoCamera
    from pyslam_tpu_torch.testing import VO_CAM, exposure_ramp, vo_stereo_frames

    frames = vo_stereo_frames(16)
    cam = StereoCamera(b=0.3, **VO_CAM)
    t0 = time.perf_counter()
    disp = compute_disparity(frames[0][0], frames[0][1], "tpu").astype(np.float32)
    runs = {}
    for name, affine in (("seq", False), ("affine", True)):
        pipe = DenseStereoPipeline(cam, pyrlevels=4, keyframe_trans_thresh=1e9, matcher="tpu",
                                   affine_illumination=affine)
        for k, (left, right, _) in enumerate(frames):
            pipe.track(exposure_ramp(left, k) if affine else left, right)
        runs[name] = np.stack(pipe.T_c_w)
    out = dict(seconds=time.perf_counter() - t0, valid=float(np.isfinite(disp).mean()))
    print(f"47 VGA stereo VO: disparity valid {out['valid']:.3f}, {out['seconds']:.1f} s", flush=True)
    return out, {"p47_disp": disp, "p47_seq": runs["seq"], "p47_affine": runs["affine"]}


def stereo_slam_reference(world, gt, frames):
    """``examples/stereo_slam.py``'s ``main`` on the given data, in float32:
    the ATE (m) after the odometry, the pose graph and joint SLAM."""
    from pyslam_tpu.eval import TrajectoryMetrics
    from pyslam_tpu.graph.core import FactorBatch, FactorGraph, VariableBlock
    from pyslam_tpu.losses import CauchyLoss
    from pyslam_tpu.pipelines.ransac import FrameToFrameRANSAC
    from pyslam_tpu.sensors import StereoCamera
    from pyslam_tpu.solver import solve_auto
    from pyslam_tpu_torch.testing import SLAM_CAM

    cam = StereoCamera(**SLAM_CAM)
    n = len(gt)
    ransac = FrameToFrameRANSAC(cam, num_iters=256, inlier_thresh=2.0)
    samples = {}

    def relative(a, b):
        (ids_a, obs_a), (ids_b, obs_b) = frames[a], frames[b]
        common, ia, ib = np.intersect1d(ids_a, ids_b, return_indices=True)
        if len(common) < 12:
            return None
        # the draw of _ransac_batched (pyslam_tpu/pipelines/ransac.py:102)
        samples[len(common)] = np.asarray(jax.random.randint(jax.random.PRNGKey(ransac.seed), (256, 3), 0,
                                                             len(common)))
        T, mask = ransac.compute_transform(obs_a[ia].astype(np.float32), obs_b[ib].astype(np.float32))
        return None if mask.sum() < 10 else np.asarray(T.mat)

    edges, est = [], [gt[0]]
    for k in range(1, n):
        T_rel = relative(k - 1, k)
        edges.append((k - 1, k, T_rel))
        est.append(T_rel @ est[-1])
    for k in range(n):
        for j in range(k + 5, n):
            if np.linalg.norm(np.linalg.inv(gt[k])[:3, 3] - np.linalg.inv(gt[j])[:3, 3]) < 2.5:
                T_rel = relative(k, j)
                if T_rel is not None:
                    edges.append((k, j, T_rel))

    def ate(T_c_w):
        return float(TrajectoryMetrics(np.linalg.inv(gt), np.linalg.inv(T_c_w)).armse("trans"))

    const = np.zeros(n, bool)
    const[0] = True
    between = FactorBatch.create(
        kind="between_se3", slots=("poses", "poses"),
        indices=(np.array([e[0] for e in edges], np.int32), np.array([e[1] for e in edges], np.int32)),
        data={"T_obs": jnp.asarray(np.stack([e[2] for e in edges]), jnp.float32),
              "sqrt_info": jnp.broadcast_to(jnp.eye(6, dtype=jnp.float32) * 10.0, (len(edges), 6, 6))},
        loss=CauchyLoss(2.0))
    graph = FactorGraph({"poses": VariableBlock.create("se3", jnp.asarray(np.stack(est), jnp.float32), const)},
                        [between])
    solved, info = solve(graph, Options(method="lm", max_iters=50))
    opt = np.asarray(solved.blocks["poses"].values)

    obs_cam = np.concatenate([np.full(len(ids), k, np.int32) for k, (ids, _) in enumerate(frames)])
    obs_world = np.concatenate([ids for ids, _ in frames]).astype(np.int32)
    obs_uvd = np.concatenate([obs for _, obs in frames])
    first_obs = {}
    for k, (ids, obs) in enumerate(frames):
        for row, wid in enumerate(ids):
            first_obs.setdefault(int(wid), (k, obs[row]))
    used = np.unique(obs_world)
    remap = np.full(world.shape[0], -1, np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    lm_init = np.zeros((len(used), 3), np.float32)
    for wid in used:
        k, o = first_obs[int(wid)]
        p_cam = np.asarray(cam.triangulate(jnp.asarray(o[None].astype(np.float32))))[0]
        T_w_c = np.linalg.inv(opt[k])
        lm_init[remap[wid]] = T_w_c[:3, :3] @ p_cam + T_w_c[:3, 3]
    slam = FactorGraph(
        {"poses": VariableBlock.create("se3", jnp.asarray(opt, jnp.float32), const),
         "landmarks": VariableBlock.create("euclidean", jnp.asarray(lm_init))},
        [FactorBatch.create(kind="reprojection", slots=("poses", "landmarks"), indices=(obs_cam, remap[obs_world]),
                            data={"obs": jnp.asarray(obs_uvd, jnp.float32), "sqrt_info": jnp.eye(3, dtype=jnp.float32),
                                  "camera": cam},
                            loss=CauchyLoss(3.0)),
         between])
    refined, info2 = solve_auto(slam, Options(method="lm", max_iters=30))
    opt2 = np.asarray(refined.blocks["poses"].values)
    return dict(ate_odometry=ate(np.stack(est)), ate_pose_graph=ate(opt), ate_joint=ate(opt2), edges=len(edges),
                pose_graph_iterations=int(info.iterations), landmarks=len(used), observations=len(obs_cam)), samples


def phase48():
    """``examples/stereo_slam.py`` at its size: the three ATEs."""
    from pyslam_tpu_torch.testing import stereo_slam_world

    t0 = time.perf_counter()
    jax.config.update("jax_enable_x64", False)
    try:
        out, samples = stereo_slam_reference(*stereo_slam_world(n_frames=40, seed=0))
    finally:
        jax.config.update("jax_enable_x64", True)
    out["seconds"] = time.perf_counter() - t0
    counts = np.array(sorted(samples))
    print(f"48 stereo SLAM: ATE {out['ate_odometry']!r} -> {out['ate_pose_graph']!r} -> {out['ate_joint']!r} m, "
          f"{out['seconds']:.1f} s", flush=True)
    return out, {"p48_ate": np.array([out["ate_odometry"], out["ate_pose_graph"], out["ate_joint"]]),
                 "p48_sample_counts": counts, "p48_samples": np.stack([samples[c] for c in counts])}


def phasef32():
    import torch

    import pyslam_tpu.solver.bcsr as jbcsr
    import pyslam_tpu.solver.schur as jschur
    import pyslam_tpu_torch.solver.bcsr as tbcsr
    import pyslam_tpu_torch.solver.schur as tschur
    from pyslam_tpu_torch.graph import build as tbuild
    from pyslam_tpu_torch.io import synth as tsynth
    from pyslam_tpu_torch.solver import Options as TOptions

    counts = {"jax": [], "port": []}

    def jax_counted(fn):
        def counted(*args, **kw):
            x, it = fn(*args, **kw)
            jax.debug.callback(lambda n: counts["jax"].append(int(n)), it)
            return x, it
        return counted

    def port_counted(fn, field):
        def counted(*args, **kw):
            out = fn(*args, **kw)
            counts["port"].append(int(out.iterations if field else out[1]))
            return out
        return counted

    jbcsr.pcg_solve = jax_counted(jbcsr.pcg_solve)
    jschur.pcg_solve = jax_counted(jschur.pcg_solve)
    tbcsr.ell_pcg = port_counted(tbcsr.ell_pcg, True)
    tschur.pcg_solve = port_counted(tschur.pcg_solve, False)
    torch.set_num_threads(4)

    def record(name, run_jax, run_port):
        out = {}
        for pkg, run in (("jax", run_jax), ("port", run_port)):
            counts[pkg].clear()
            t0 = time.perf_counter()
            info = run()
            jax.effects_barrier()
            out[pkg] = dict(chi2=float(info.chi2), iterations=int(info.iterations), status=int(info.status),
                            cg_iterations=list(counts[pkg]), seconds=time.perf_counter() - t0)
            print(name, pkg, out[pkg], flush=True)
        return out

    sphere = dict(n_poses=2500, seed=0)
    o4 = dict(method="lm", max_iters=30, min_cost_decrease=0.999)
    ba = dict(n_cams=49, n_pts=7000, seed=0)
    o10 = dict(method="lm", max_iters=25)
    out = {}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        key = tdt.__repr__().split(".")[-1]
        out[f"sphere2500_{key}"] = record(
            f"sphere2500_{key}",
            lambda: jbcsr.solve_ell(build.pose_graph(synth.se3_sphere(**sphere), dtype=jdt), Options(**o4),
                                    pcg_rtol=3e-6, pcg_max_iters=120)[1],
            lambda: tbcsr.solve_ell(tbuild.pose_graph(tsynth.se3_sphere(**sphere), dtype=tdt, device="cpu"),
                                    TOptions(**o4), pcg_rtol=3e-6, pcg_max_iters=120)[1])
        out[f"config4_pcg_{key}"] = record(
            f"config4_pcg_{key}",
            lambda: jschur.solve_schur(build.ba_graph(synth.ba_synthetic(**ba), dtype=jdt), Options(**o10),
                                       mode="pcg", pcg_rtol=1e-4, pcg_max_iters=30)[1],
            lambda: tschur.solve_schur(tbuild.ba_graph(tsynth.ba_synthetic(**ba), dtype=tdt, device="cpu"),
                                       TOptions(**o10), mode="pcg", pcg_rtol=1e-4, pcg_max_iters=30)[1])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="28,29,30,31,32,33,34,35,36")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                                  "chip_smoke_refs.npz"), help="npz of the arrays (merged into)")
    args = ap.parse_args()
    t0 = time.perf_counter()
    out, arrays = {}, {}
    for p in args.phases.split(","):
        res = globals()[f"phase{p}"]()
        if isinstance(res, tuple):
            res, more = res
            arrays.update(more)
        out[p] = res
    if arrays:
        if os.path.exists(args.out):
            arrays = {**dict(np.load(args.out)), **arrays}
        np.savez_compressed(args.out, **arrays)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
