"""Reference numbers for the PyTorch port's chip smoke (``chip_smoke.py``
phases 28 to 31), computed once with the JAX package on the CPU in f64 on
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
      solved by LM 60: chi2 and LM iterations.

The port never imports this script; its numbers are constants in
``chip_smoke.py``.  Run from the repository root (minutes; phase 30 holds a
dense f64 H of 11,008 x 11,008, about 1 GB):

    python scripts/torch_port_refs.py [--phases 28,29,30,31]
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


def vio_inputs(exp):
    """(ImuData, T_prior) of phase 31: ``examples/vio.py``'s trajectory at
    400 keyframes; ``exp`` is an SE(3) exponential on a (6,) numpy vector."""
    b_g = np.array([0.002, -0.001, 0.003])
    b_a = np.array([0.05, -0.03, 0.02])
    d = synth.imu_circle(n_keyframes=400, kf_dt=0.5, imu_rate=200, gyro_noise=1.7e-4 * np.sqrt(200),
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="28,29,30,31")
    args = ap.parse_args()
    t0 = time.perf_counter()
    out = {p: globals()[f"phase{p}"]() for p in args.phases.split(",")}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
