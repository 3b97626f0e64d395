"""EuRoC MAV dataset format I/O (ASL format) — the standard VIO benchmark.

The canonical files are not on disk in this environment (SURVEY.md §0), so
these readers/writers exist for the same reason as io/g2o.py and io/bal.py:
the day real EuRoC sequences are obtainable, the visual-inertial stack
(pyslam_tpu/imu.py) runs on them unmodified; until then the writers produce
format-exact synthetic files and the tests round-trip through them.

Files (ASL layout, comma-separated, one header line starting with '#'):
  imu0/data.csv:     t[ns], w_x, w_y, w_z [rad/s], a_x, a_y, a_z [m/s^2]
  state_groundtruth_estimate0/data.csv:
      t[ns], p_x, p_y, p_z, q_w, q_x, q_y, q_z,
      v_x, v_y, v_z, b_w_x, b_w_y, b_w_z, b_a_x, b_a_y, b_a_z
Ground-truth poses are body-to-world (T_WB); ``read_groundtruth`` returns
them converted to this framework's world-to-body convention (T_b_w).
"""

from __future__ import annotations

import numpy as np

from .trajectory import _quat_from_R, _R_from_quat


def _read_csv(path):
    """(t_ns (N,) int64, values (N, D) float64).  Timestamps are parsed as
    int64: real EuRoC epochs are ~1.4e18 ns, beyond float64's 2^53 integer
    range — parsing them as float quantizes at ~256 ns and jitters every
    dt/boundary comparison downstream."""
    ts, rows = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split(",")
            ts.append(int(tok[0]))
            rows.append([float(v) for v in tok[1:]])
    return np.asarray(ts, np.int64), np.asarray(rows)


def first_timestamp_ns(path) -> int:
    """The file's first timestamp — use ONE file's origin for every file of
    a sequence so the relative times stay mutually aligned."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                return int(line.split(",")[0])
    raise ValueError(f"no records in {path}")


def _rel_seconds(t_ns, origin_ns):
    origin = int(t_ns[0]) if origin_ns is None else int(origin_ns)
    return (t_ns - origin).astype(np.float64) * 1e-9


def read_imu(path, origin_ns: int | None = None):
    """imu0/data.csv -> (t (K,) seconds, omega (K, 3), accel (K, 3)).

    ``t`` is relative to ``origin_ns`` (default: this file's first record)
    so it is float64-exact; pass one shared origin when aligning several
    files (``first_timestamp_ns``)."""
    t_ns, M = _read_csv(path)
    return _rel_seconds(t_ns, origin_ns), M[:, 0:3], M[:, 3:6]


def write_imu(path, t, omega, accel):
    """Inverse of read_imu (t in seconds)."""
    with open(path, "w") as f:
        f.write("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
                "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
                "a_RS_S_z [m s^-2]\n")
        for k in range(len(t)):
            f.write(
                f"{int(round(t[k] * 1e9))},"
                + ",".join(f"{v:.9g}" for v in omega[k])
                + ","
                + ",".join(f"{v:.9g}" for v in accel[k])
                + "\n"
            )


def _quat_wxyz_to_R(q):
    """EuRoC stores scalar-FIRST quaternions; io/trajectory.py's scipy
    helpers are scalar-last — reorder instead of re-deriving the math."""
    q = np.asarray(q)
    return _R_from_quat(np.concatenate([q[1:], q[:1]]))


def _R_to_quat_wxyz(R):
    q = _quat_from_R(np.asarray(R))
    return np.concatenate([q[3:], q[:3]])


def read_groundtruth(path, origin_ns: int | None = None):
    """state_groundtruth_estimate0/data.csv ->
    (t (N,) s, T_b_w (N, 4, 4), v (N, 3), b_gyro (N, 3), b_accel (N, 3)).

    The file stores T_WB (body-to-world); returned poses are inverted into
    the framework's world-to-body convention.  ``t`` is relative to
    ``origin_ns`` (default: this file's first record)."""
    t_ns, M = _read_csv(path)
    t = _rel_seconds(t_ns, origin_ns)
    N = len(M)
    T = np.zeros((N, 4, 4))
    for i in range(N):
        R_wb = _quat_wxyz_to_R(M[i, 3:7])
        T[i] = np.eye(4)
        T[i][:3, :3] = R_wb.T
        T[i][:3, 3] = -R_wb.T @ M[i, 0:3]
    return t, T, M[:, 7:10], M[:, 10:13], M[:, 13:16]


def write_groundtruth(path, t, T_b_w, v, b_gyro=None, b_accel=None):
    """Inverse of read_groundtruth (poses in the framework convention)."""
    N = len(t)
    b_gyro = np.zeros((N, 3)) if b_gyro is None else np.broadcast_to(b_gyro, (N, 3))
    b_accel = np.zeros((N, 3)) if b_accel is None else np.broadcast_to(b_accel, (N, 3))
    with open(path, "w") as f:
        f.write("#timestamp,p_RS_R_x [m],p_RS_R_y [m],p_RS_R_z [m],"
                "q_RS_w [],q_RS_x [],q_RS_y [],q_RS_z [],"
                "v_RS_R_x [m s^-1],v_RS_R_y [m s^-1],v_RS_R_z [m s^-1],"
                "b_w_RS_S_x [rad s^-1],b_w_RS_S_y [rad s^-1],b_w_RS_S_z [rad s^-1],"
                "b_a_RS_S_x [m s^-2],b_a_RS_S_y [m s^-2],b_a_RS_S_z [m s^-2]\n")
        for k in range(N):
            A = T_b_w[k][:3, :3]
            p = -A.T @ T_b_w[k][:3, 3]
            q = _R_to_quat_wxyz(A.T)
            row = (
                [int(round(t[k] * 1e9))]
                + list(p)
                + list(q)
                + list(v[k])
                + list(b_gyro[k])
                + list(b_accel[k])
            )
            f.write(",".join(f"{x:.9g}" if i else str(x) for i, x in enumerate(row)) + "\n")


def segment_imu(t_imu, omega, accel, t_keyframes):
    """Split a continuous IMU stream into per-keyframe-interval sample
    arrays for ``imu.preintegrate``: returns a list of (omega_i, accel_i,
    dts_i) whose dts sum EXACTLY to t_kf[i+1] - t_kf[i].

    Camera timestamps do not coincide with IMU sample times on real data,
    so the gap [t_kf[i], t_first_sample) is covered by zero-order hold of
    the last sample BEFORE the boundary (the nearest measurement of the
    signal over that gap); dropping it instead would lose up to one IMU
    period of gravity integration per interval — a systematic dv bias."""
    out = []
    for i in range(len(t_keyframes) - 1):
        lo, hi = t_keyframes[i], t_keyframes[i + 1]
        sel = np.nonzero((t_imu >= lo) & (t_imu < hi))[0]
        if len(sel) == 0:
            raise ValueError(f"no IMU samples in keyframe interval {i}")
        idx = list(sel)
        times = list(t_imu[sel])
        if times[0] > lo:
            # hold the last pre-boundary sample (or the first in-interval
            # one when the stream starts inside the interval) across the gap
            hold = sel[0] - 1 if sel[0] > 0 else sel[0]
            idx = [hold] + idx
            times = [lo] + times
        bounds = np.asarray(times + [hi])
        dts = np.diff(bounds)
        out.append((omega[idx], accel[idx], dts))
    return out
