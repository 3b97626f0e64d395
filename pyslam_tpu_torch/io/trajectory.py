"""Trajectory file I/O: TUM and KITTI formats.

The reference's users evaluate with external tooling (evo, KITTI devkit);
these writers/readers make pyslam_tpu trajectories interchangeable with that
ecosystem.

Formats:
  * TUM:   one line per pose: ``timestamp tx ty tz qx qy qz qw`` (pose =
    T_w_c, camera-to-world).
  * KITTI: one line per pose: the 12 row-major entries of the 3x4 ``[R | t]``
    camera-to-world matrix.
"""

from __future__ import annotations

import numpy as np


def _quat_from_R(R):
    """(..., 3, 3) -> (..., 4) quaternion [qx, qy, qz, qw] (scalar-last,
    TUM convention)."""
    from scipy.spatial.transform import Rotation

    flat = R.reshape(-1, 3, 3)
    q = Rotation.from_matrix(flat).as_quat()  # scalar-last
    return q.reshape(R.shape[:-2] + (4,))


def _R_from_quat(q):
    from scipy.spatial.transform import Rotation

    flat = np.asarray(q).reshape(-1, 4)
    R = Rotation.from_quat(flat).as_matrix()
    return R.reshape(np.asarray(q).shape[:-1] + (3, 3))


def write_tum(path: str, T_w_c, timestamps=None) -> None:
    """Write camera-to-world poses (N, 4, 4) in TUM format."""
    T = np.asarray(T_w_c)
    if timestamps is None:
        timestamps = np.arange(len(T), dtype=np.float64)
    q = _quat_from_R(T[:, :3, :3])
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, Tk, qk in zip(timestamps, T, q):
            t = Tk[:3, 3]
            f.write(
                f"{ts:.6f} {t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                f"{qk[0]:.9g} {qk[1]:.9g} {qk[2]:.9g} {qk[3]:.9g}\n"
            )


def read_tum(path: str):
    """Read a TUM trajectory -> (timestamps (N,), T_w_c (N, 4, 4))."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.split()])
    arr = np.asarray(rows)
    ts = arr[:, 0]
    T = np.tile(np.eye(4), (len(arr), 1, 1))
    T[:, :3, 3] = arr[:, 1:4]
    T[:, :3, :3] = _R_from_quat(arr[:, 4:8])
    return ts, T


def write_kitti(path: str, T_w_c) -> None:
    """Write camera-to-world poses (N, 4, 4) in KITTI format (12 floats of
    the 3x4 row-major matrix per line)."""
    T = np.asarray(T_w_c)
    with open(path, "w") as f:
        for Tk in T:
            f.write(" ".join(f"{x:.9g}" for x in Tk[:3, :4].reshape(-1)) + "\n")


def read_kitti(path: str):
    """Read a KITTI trajectory -> T_w_c (N, 4, 4)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rows.append([float(x) for x in line.split()])
    arr = np.asarray(rows).reshape(-1, 3, 4)
    T = np.tile(np.eye(4), (len(arr), 1, 1))
    T[:, :3, :4] = arr
    return T


__all__ = ["write_tum", "read_tum", "write_kitti", "read_kitti"]
