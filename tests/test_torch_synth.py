"""The port's copy of the synthetic generators gives the reference's
arrays, bit for bit (the generators are numpy only)."""

import dataclasses

import numpy as np
import pytest

from pyslam_tpu.io import synth as jsynth
from pyslam_tpu_torch.io import synth as tsynth
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

GENERATORS = [
    ("se3_sphere", dict(n_poses=80, seed=3)),
    ("se3_sphere", dict(n_poses=2500, seed=0)),
    ("se2_loop", dict(n_poses=30, n_loops=4, seed=1)),
    ("se2_manhattan", dict(n_poses=60, seed=2)),
    ("landmark_slam_2d", dict(seed=4)),
    ("ba_synthetic", dict(n_cams=4, n_pts=20, seed=5)),
    ("sim3_loop", dict(seed=6)),
    ("imu_circle", dict(seed=7)),
]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name,kw", GENERATORS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(GENERATORS)])
def test_generator_is_identical(name, kw):
    ref = getattr(jsynth, name)(**kw)
    out = getattr(tsynth, name)(**kw)
    assert type(out).__name__ == type(ref).__name__
    rf, of = _fields(ref), _fields(out)
    assert rf.keys() == of.keys()
    for k, v in rf.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(of[k], v, err_msg=k)
        else:
            assert of[k] == v, k


def test_with_outliers_se3_matches_reference():
    """The outlier measurements go through each package's own SE(3) exp,
    so they agree to rounding (1e-12), the rest exactly."""
    data = jsynth.se3_sphere(n_poses=40, seed=1)
    rd, rm = jsynth.with_outliers(data, n_outliers=5, seed=2)
    od, om = tsynth.with_outliers(tsynth.se3_sphere(n_poses=40, seed=1), n_outliers=5, seed=2)
    np.testing.assert_array_equal(om, rm)
    np.testing.assert_array_equal(od.edges_i, rd.edges_i)
    np.testing.assert_array_equal(od.edges_j, rd.edges_j)
    np.testing.assert_array_equal(od.sqrt_info, rd.sqrt_info)
    np.testing.assert_allclose(od.T_meas, rd.T_meas, rtol=0, atol=1e-12)


def test_with_outliers_se2_matches_reference():
    """SE(2) outliers go through each package's own SE(2) exp."""
    rd, rm = jsynth.with_outliers(jsynth.se2_loop(n_poses=20, n_loops=2, seed=0), n_outliers=4, seed=3)
    od, om = tsynth.with_outliers(tsynth.se2_loop(n_poses=20, n_loops=2, seed=0), n_outliers=4, seed=3)
    np.testing.assert_array_equal(om, rm)
    np.testing.assert_array_equal(od.edges_i, rd.edges_i)
    np.testing.assert_array_equal(od.edges_j, rd.edges_j)
    np.testing.assert_array_equal(od.sqrt_info, rd.sqrt_info)
    np.testing.assert_allclose(od.T_meas, rd.T_meas, rtol=0, atol=1e-12)
