"""Fixed-lag smoothers of the torch port (``solver/fixed_lag.py``) against
the JAX reference, in f64 on the CPU, streamed with the same feed
(``pyslam_tpu_torch.testing.drive_fixed_lag`` /
``drive_fixed_lag_landmarks``, the feeds of ``tests/test_fixed_lag.py``)
over the same seeded data.

Tolerances: every pose as it leaves the window and the last window within
1e-9 of the reference's (the two solve the same dense window systems, whose
summation orders differ); landmarks 1e-9; the retirements the same ids in
the same order.  The reference's own criteria against the batch solve are
in ``tests/test_fixed_lag.py``; here the no-marginalization window is also
held to 5e-7 of the batch GN solve, as there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import fixed_lag as jfl
from pyslam_tpu_torch.solver import fixed_lag as tfl
from pyslam_tpu_torch.testing import drive_fixed_lag, drive_fixed_lag_landmarks, window_trajectory
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = dict(j=jnp.float64, t=torch.float64)


def _pair(cls, **kw):
    return (getattr(jfl, cls)(dtype=F64["j"], **kw),
            getattr(tfl, cls)(dtype=F64["t"], device="cpu", **kw))


POSE_CASES = {
    # name: (data, n, smoother arguments)
    "se2_no_marginalization": (lambda: jsynth.se2_loop(n_poses=12, n_loops=4, seed=0), 12,
                               dict(window=12, kind="se2", gn_iters=8, anchor_sqrt_info=1e6)),
    "se2_sliding": (lambda: jsynth.se2_loop(n_poses=40, n_loops=20, seed=5), 40,
                    dict(window=8, kind="se2", gn_iters=3, anchor_sqrt_info=1e5)),
    "se3_sliding": (lambda: jsynth.se3_sphere(n_poses=30, n_loops=8, seed=3), 30,
                    dict(window=8, kind="se3", gn_iters=4, anchor_sqrt_info=1e4)),
    "sim3_sliding": (lambda: jsynth.sim3_loop(n_poses=20, n_loops=3, scale_drift=0.01, odo_scale_std=0.005,
                                              seed=3), 20, dict(window=7, kind="sim3", gn_iters=3)),
}


@pytest.mark.parametrize("name", sorted(POSE_CASES))
def test_pose_window_matches_reference(name):
    make, n, kw = POSE_CASES[name]
    data = make()
    (jsm, tsm) = _pair("FixedLagSmoother", **kw)
    ref = window_trajectory(*drive_fixed_lag(jsm, data, n), n)
    out = window_trajectory(*drive_fixed_lag(tsm, data, n), n)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9)
    assert (tsm.first_id, tsm.count) == (jsm.first_id, jsm.count)
    np.testing.assert_array_equal(tsm.fi, jsm.fi)
    np.testing.assert_array_equal(tsm.fj, jsm.fj)
    np.testing.assert_allclose(tsm.Hp.numpy(), np.asarray(jsm.Hp), rtol=0, atol=1e-9 * np.abs(np.asarray(jsm.Hp)).max())
    if name == "se2_no_marginalization":
        from pyslam_tpu_torch.graph import build
        from pyslam_tpu_torch.io import synth
        from pyslam_tpu_torch.solver import Options, solve_auto

        g = build.pose_graph(synth.se2_loop(n_poses=12, n_loops=4, seed=0), dtype=torch.float64, device="cpu")
        s, _ = solve_auto(g, Options(method="gn", max_iters=20, min_cost_decrease=0.9999))
        np.testing.assert_allclose(tsm.poses(), s.blocks["poses"].values.numpy(), atol=5e-7)


def _lm_data(seed, n, n_landmarks, obs_type="xy", **kw):
    return jsynth.landmark_slam_2d(n_poses=n, n_landmarks=n_landmarks, obs_type=obs_type, seed=seed, **kw)


LANDMARK_CASES = {
    "xy_no_marginalization": (lambda: _lm_data(0, 12, 8), 12,
                              dict(window=12, lm_slots=8, obs_kind="landmark_xy_se2", kind="se2", gn_iters=8,
                                   anchor_sqrt_info=1e6)),
    "xy_evicting": (lambda: _lm_data(3, 25, 12), 25,
                    dict(window=6, lm_slots=8, obs_kind="landmark_xy_se2", kind="se2", gn_iters=2, obs_capacity=64)),
    "bearing_range_evicting": (lambda: _lm_data(0, 40, 20, obs_type="bearing_range", max_range=10.0,
                                                odo_rot_std=0.005), 40,
                               dict(window=8, lm_slots=10, obs_kind="bearing_range_se2", kind="se2", gn_iters=3)),
}


@pytest.mark.parametrize("name", sorted(LANDMARK_CASES))
def test_landmark_window_matches_reference(name):
    make, n, kw = LANDMARK_CASES[name]
    data = make()
    jsm, tsm = _pair("FixedLagLandmarkSmoother", **kw)
    jleft, jlast, jret = drive_fixed_lag_landmarks(jsm, data, n)
    tleft, tlast, tret = drive_fixed_lag_landmarks(tsm, data, n)
    np.testing.assert_allclose(window_trajectory(tleft, tlast, n), window_trajectory(jleft, jlast, n), rtol=0,
                               atol=1e-9)
    assert [i for i, _ in tret] == [i for i, _ in jret]
    if "evicting" in name:
        assert len(tret) > 0  # slot pressure retired landmarks
    for (_, a), (_, b) in zip(tret, jret):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert tsm.landmark_ids() == jsm.landmark_ids()
    for i in tsm.landmark_ids():
        np.testing.assert_allclose(tsm.landmark(i), np.asarray(jsm.landmark(i)), rtol=0, atol=1e-9)


def test_explicit_retire_and_slot_reuse():
    n = 10
    data = _lm_data(4, n, 6)
    kw = dict(window=n, lm_slots=6, obs_kind="landmark_xy_se2", kind="se2", gn_iters=4)
    jsm, tsm = _pair("FixedLagLandmarkSmoother", **kw)
    drive_fixed_lag_landmarks(jsm, data, n)
    drive_fixed_lag_landmarks(tsm, data, n)
    before = tsm.poses()
    lid = min(tsm.landmark_ids())
    slot = tsm._lm_id2slot[lid]
    for sm in (jsm, tsm):
        sm.retire_landmark(lid)
        sm.update()
    assert lid not in tsm.landmark_ids()
    with pytest.raises(KeyError):
        tsm.landmark(lid)
    with pytest.raises(KeyError):
        tsm.retire_landmark(lid)
    np.testing.assert_allclose(tsm.poses(), np.asarray(jsm.poses()), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tsm.poses(), before, atol=1e-3)  # the information is kept
    new_id = tsm.add_landmark(np.zeros(2))
    assert tsm._lm_id2slot[new_id] == slot


def test_out_of_window_and_capacity_errors():
    data = jsynth.se2_loop(n_poses=20, n_loops=0, seed=0)
    sm = tfl.FixedLagSmoother(window=4, kind="se2", dtype=torch.float64, device="cpu")
    drive_fixed_lag(sm, data, 10)
    with pytest.raises(KeyError):
        sm.add_factor(0, 9, np.eye(3), np.eye(3))
    with pytest.raises(KeyError):
        sm.pose(0)
    assert sm.pose(9).shape == (3, 3)
    sm = tfl.FixedLagSmoother(window=4, kind="se2", capacity=2, dtype=torch.float64, device="cpu")
    sm.add_pose(np.eye(3))
    sm.add_odometry(np.eye(3), np.eye(3))
    sm.add_odometry(np.eye(3), np.eye(3))
    with pytest.raises(RuntimeError, match="capacity"):
        sm.add_odometry(np.eye(3), np.eye(3))
    with pytest.raises(RuntimeError, match="initial pose"):
        tfl.FixedLagSmoother(kind="se2", device="cpu").add_odometry(np.eye(3), np.eye(3))
    with pytest.raises(ValueError, match="kind"):
        tfl.FixedLagSmoother(kind="so3", device="cpu")
    lsm = tfl.FixedLagLandmarkSmoother(window=3, lm_slots=2, obs_kind="landmark_xy_se2", kind="se2",
                                       obs_capacity=1, dtype=torch.float64, device="cpu")
    lsm.add_pose(np.eye(3))
    lid = lsm.add_landmark(np.ones(2))
    lsm.add_observation(0, lid, np.ones(2), np.eye(2))
    with pytest.raises(RuntimeError, match="observation"):
        lsm.add_observation(0, lid, np.ones(2), np.eye(2))
    with pytest.raises(KeyError):
        lsm.add_observation(5, lid, np.ones(2), np.eye(2))
    with pytest.raises(ValueError, match="obs_dim"):
        tfl.FixedLagLandmarkSmoother(obs_kind="unknown_kind", device="cpu")


def _sliding_run(edit):
    """The se2 sliding case; ``edit`` mutates every host array the caller
    handed in or got back after it was used."""
    data = jsynth.se2_loop(n_poses=30, n_loops=10, seed=1)
    sm = tfl.FixedLagSmoother(window=6, kind="se2", gn_iters=3, dtype=torch.float64, device="cpu")
    T0 = data.T_init[0].copy()
    sm.add_pose(T0)
    if edit:
        T0[:] = 7.0
    for t in range(1, 30):
        T_meas, S = data.T_meas[t - 1].copy(), data.sqrt_info[t - 1].copy()
        sm.add_odometry(T_meas, S)
        if edit:
            T_meas[:] = 3.0
            S[:] = 0.0
        est = sm.update()
        if edit:
            est[:] = 5.0
            sm.fi.copy()[:] = 0  # a copy of a mirror is the caller's
    return sm.poses()


def test_deterministic_and_host_edits_do_not_move_the_state():
    """Two identical runs agree bit for bit; editing every array the
    caller passed in (after the call) or got back (``update()``'s poses)
    changes nothing, on the CPU where ``torch.from_numpy`` would alias."""
    a, b, c = _sliding_run(False), _sliding_run(False), _sliding_run(True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def test_dense_plan_rebuilt_only_when_structure_changes():
    data = jsynth.se2_loop(n_poses=20, n_loops=6, seed=2)
    sm = tfl.FixedLagSmoother(window=5, kind="se2", gn_iters=4, dtype=torch.float64, device="cpu")
    drive_fixed_lag(sm, data, 20)
    built = sm.plans_built
    sm.update()
    sm.update()
    assert sm.plans_built == built  # no new factor: no new plan, whatever gn_iters
    # a marginalization (on the current plan) and a new factor: the changed
    # mirrors give one new plan, at the next update
    sm.add_odometry(data.T_meas[0], data.sqrt_info[0])
    sm.update()
    assert sm.plans_built == built + 1


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (tfl.FixedLagSmoother, tfl.FixedLagLandmarkSmoother):
        with pytest.raises(RuntimeError, match="device"):
            cls()
