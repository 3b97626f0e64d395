"""The port's copies of the EuRoC and trajectory file modules
(``pyslam_tpu_torch/io/euroc.py``, ``io/trajectory.py``; numpy only)
against the reference's: each writer gives the reference's file bytes and
each reader, and ``segment_imu``, the reference's arrays.  Tolerance:
exact."""

import numpy as np
import pytest

from pyslam_tpu.io import euroc as jeuroc
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.io import trajectory as jtraj
from pyslam_tpu_torch.io import euroc as teuroc
from pyslam_tpu_torch.io import trajectory as ttraj
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def sequence():
    d = jsynth.imu_circle(n_keyframes=4, kf_dt=0.5, imu_rate=200, gyro_noise=1e-3, accel_noise=1e-2,
                          b_gyro=(1e-3, -2e-3, 5e-4), b_accel=(0.02, 0.0, -0.01), seed=3)
    n_int, K = d.dts.shape
    t = np.arange(n_int * K) * d.dts[0, 0]
    return d, t, np.arange(4) * 0.5


def test_euroc_files_and_arrays_are_the_reference(tmp_path, sequence):
    d, t, t_kf = sequence
    paths = {}
    for name, mod in (("ref", jeuroc), ("port", teuroc)):
        imu_path, gt_path = tmp_path / f"{name}_imu.csv", tmp_path / f"{name}_gt.csv"
        mod.write_imu(str(imu_path), t, d.omega.reshape(-1, 3), d.accel.reshape(-1, 3))
        mod.write_groundtruth(str(gt_path), t_kf, d.T_gt, d.v_gt, b_gyro=d.b_gyro, b_accel=d.b_accel)
        paths[name] = (imu_path, gt_path)
    for i in range(2):
        assert paths["ref"][i].read_bytes() == paths["port"][i].read_bytes()
    imu_path, gt_path = (str(p) for p in paths["port"])
    assert teuroc.first_timestamp_ns(imu_path) == jeuroc.first_timestamp_ns(imu_path)
    origin = jeuroc.first_timestamp_ns(imu_path)
    _same(teuroc.read_imu(imu_path, origin_ns=origin), jeuroc.read_imu(imu_path, origin_ns=origin))
    _same(teuroc.read_groundtruth(gt_path), jeuroc.read_groundtruth(gt_path))
    t2, w2, a2 = jeuroc.read_imu(imu_path)
    _same(teuroc.segment_imu(t2, w2, a2, t_kf), jeuroc.segment_imu(t2, w2, a2, t_kf))


def test_segment_imu_off_grid_boundaries_is_the_reference():
    """Keyframe times between IMU samples: the zero-order hold gives
    intervals of unequal length, the same in both copies."""
    rng = np.random.default_rng(0)
    t = np.arange(400) * 0.005
    w, a = rng.normal(0, 0.1, (400, 3)), rng.normal(0, 1.0, (400, 3))
    t_kf = np.array([0.0, 0.5012, 1.0031, 1.4987])
    segs = teuroc.segment_imu(t, w, a, t_kf)
    _same(segs, jeuroc.segment_imu(t, w, a, t_kf))
    assert len({len(s[2]) for s in segs}) > 1
    with pytest.raises(ValueError):
        teuroc.segment_imu(np.array([0.0, 0.1]), np.zeros((2, 3)), np.zeros((2, 3)), np.array([0.0, 0.05, 0.07, 0.2]))


@pytest.mark.parametrize("fmt", ["tum", "kitti"])
def test_trajectory_files_and_arrays_are_the_reference(tmp_path, sequence, fmt):
    d, _, t_kf = sequence
    T_w_c = np.linalg.inv(d.T_gt)
    out = {}
    for name, mod in (("ref", jtraj), ("port", ttraj)):
        path = str(tmp_path / f"{name}.{fmt}")
        if fmt == "tum":
            mod.write_tum(path, T_w_c, timestamps=t_kf)
        else:
            mod.write_kitti(path, T_w_c)
        out[name] = path
    assert open(out["ref"], "rb").read() == open(out["port"], "rb").read()
    reader = f"read_{fmt}"
    _same(getattr(ttraj, reader)(out["port"]), getattr(jtraj, reader)(out["port"]))
