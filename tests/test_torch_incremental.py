"""The incremental smoother of the torch port (``solver/incremental.py``)
against the JAX reference, in f64 on the CPU, fed the same streams.

Tolerances: every update's chi2 within 1e-9 relative (1e-12 absolute for
a chi2 of roundoff, an odometry chain) and its LM iterations
equal; the live poses (and landmarks) within 1e-9 after every update;
``compiles`` equal to the reference's count.  The two solve the same padded
graphs (the same x1.5 buckets) with the same LM decisions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.sensors import StereoCamera as JStereo
from pyslam_tpu.solver import Options as JOptions
from pyslam_tpu.solver import incremental as jinc
from pyslam_tpu_torch.sensors import StereoCamera as TStereo
from pyslam_tpu_torch.solver import Options
from pyslam_tpu_torch.solver import incremental as tinc
from pyslam_tpu_torch.testing import drive_incremental


def _pair(opts, **kw):
    return (jinc.IncrementalSmoother(options=JOptions(**opts), **kw),
            tinc.IncrementalSmoother(options=Options(**opts), device="cpu", **kw))


def _same_state(tsm, jsm):
    assert (tsm.n, tsm.cap, tsm.m, tsm.fcap, tsm.compiles) == (jsm.n, jsm.cap, jsm.m, jsm.fcap, jsm.compiles)
    np.testing.assert_allclose(tsm.poses(), np.asarray(jsm.poses()), rtol=0, atol=1e-9)
    if tsm.obs_kind is not None:
        np.testing.assert_allclose(tsm.landmarks(), np.asarray(jsm.landmarks()), rtol=0, atol=1e-9)


def _same_updates(t_ups, j_ups):
    assert [i for _, i in t_ups] == [i for _, i in j_ups]
    np.testing.assert_allclose([c for c, _ in t_ups], [c for c, _ in j_ups], rtol=1e-9, atol=1e-12)


def test_pose_graph_stream_matches_reference():
    """se2_loop(40): an update every 3 poses across four capacity buckets,
    then ``marginalize_oldest`` and more poses."""
    data = jsynth.se2_loop(n_poses=40, n_loops=6, seed=2)
    jsm, tsm = _pair(dict(method="lm", max_iters=15), kind="se2")
    _same_updates(drive_incremental(tsm, data, every=3), drive_incremental(jsm, data, every=3))
    _same_state(tsm, jsm)
    assert 1 < tsm.compiles < 13  # buckets: far fewer structures than updates
    for sm in (jsm, tsm):
        sm.marginalize_oldest(keep_last=10)
    assert tsm.n == 11 and [fb.kind.startswith("dense_prior") for fb in tsm._prior_batches] == [True]
    ups = {}
    for name, sm in (("j", jsm), ("t", tsm)):
        _, info = sm.update()
        ups[name] = [(float(info.chi2), int(info.iterations))]
        for k in range(40, 44):  # keep streaming odometry after retirement
            i = sm.add_pose(data.T_meas[k - 40] @ sm.poses()[sm.n - 1])
            sm.add_between(i - 1, i, data.T_meas[k - 40], data.sqrt_info[k - 40])
        _, info = sm.update()
        ups[name].append((float(info.chi2), int(info.iterations)))
    _same_updates(ups["t"], ups["j"])
    _same_state(tsm, jsm)


def test_marginalize_oldest_keeps_the_estimate():
    """Pure odometry: the FEJ prior keeps the kept estimates through a
    re-solve (the reference's 1e-8 on the newest five)."""
    data = jsynth.se2_loop(n_poses=30, n_loops=0, seed=4)
    jsm, tsm = _pair(dict(method="lm", max_iters=10), kind="se2")
    for sm in (jsm, tsm):
        drive_incremental(sm, data, every=30)
    before = tsm.poses()[-5:]
    for sm in (jsm, tsm):
        sm.marginalize_oldest(keep_last=10)
    assert tsm.n == 11
    est, _ = tsm.update()
    jsm.update()
    np.testing.assert_allclose(est[-5:], before, rtol=0, atol=1e-8)
    _same_state(tsm, jsm)
    tsm.marginalize_oldest(keep_last=20)  # nothing to retire
    assert tsm.n == 11


def _stream_landmarks(sm, data, update_every, keep_window=None):
    """``tests/test_incremental.py``'s online landmark SLAM stream."""
    lm_id, obs_by_pose, ups = {}, {}, []
    for m in range(len(data.obs_pose)):
        obs_by_pose.setdefault(int(data.obs_pose[m]), []).append(m)
    n = len(data.T_init)
    prev = None
    for k in range(n):
        if k == 0:
            prev = sm.add_pose(data.T_init[0])
        else:
            cur = sm.add_pose(data.T_meas[k - 1] @ sm.poses()[prev])
            sm.add_between(prev, cur, data.T_meas[k - 1], data.sqrt_info[k - 1])
            prev = cur
        for m in obs_by_pose.get(k, []):
            lj = int(data.obs_lm[m])
            if lj not in lm_id:
                b, r = data.obs[m]
                p_local = np.array([r * np.cos(b), r * np.sin(b)])
                Tk = sm.poses()[prev]
                lm_id[lj] = sm.add_landmark(Tk[:2, :2].T @ (p_local - Tk[:2, 2]))
            sm.add_observation(prev, lm_id[lj], data.obs[m], data.obs_sqrt_info[m])
        if k % update_every == 0 or k == n - 1:
            _, info = sm.update()
            ups.append((float(info.chi2), int(info.iterations)))
            if keep_window and sm.n > keep_window + 4:
                sm.marginalize_oldest(keep_window)
                prev = sm.n - 1
    return ups


@pytest.mark.parametrize("keep_window", [None, 10])
def test_landmark_stream_matches_reference(keep_window):
    """Bearing-range landmark SLAM through ``solve_auto`` (the Schur routes,
    ``schur_sparse_pair_budget=0``); with ``keep_window`` the carried
    priors span poses and landmarks and the graph takes the dense path."""
    data = jsynth.landmark_slam_2d(n_poses=22, n_landmarks=12, max_range=9.0, obs_type="bearing_range", seed=8)
    jsm, tsm = _pair(dict(method="lm", max_iters=15), kind="se2", obs_kind="bearing_range_se2")
    t_ups = _stream_landmarks(tsm, data, 6, keep_window)
    j_ups = _stream_landmarks(jsm, data, 6, keep_window)
    _same_updates(t_ups, j_ups)
    _same_state(tsm, jsm)
    if keep_window:
        assert tsm._prior_batches and tsm.n <= keep_window + 4


def test_visual_ba_with_camera_extras():
    """'reprojection' with the stereo camera in ``obs_extras``: online
    visual BA through the smoother (the camera survives every rebuild)."""
    data = jsynth.ba_synthetic(n_cams=5, n_pts=24, seed=0)
    opts = dict(method="lm", max_iters=10)
    sms = (jinc.IncrementalSmoother(kind="se3", obs_kind="reprojection", options=JOptions(**opts),
                                    obs_extras={"camera": JStereo(**data.camera)}),
           tinc.IncrementalSmoother(kind="se3", obs_kind="reprojection", options=Options(**opts), device="cpu",
                                    obs_extras={"camera": TStereo(**data.camera)}))
    obs_by_cam = {}
    for m in range(len(data.cam_idx)):
        obs_by_cam.setdefault(int(data.cam_idx[m]), []).append(m)
    ups = ([], [])
    for sm, up in zip(sms, ups):
        lm_id = {}
        for k in range(5):
            i = sm.add_pose(data.T_init[k])
            if k:
                sm.add_between(k - 1, k, data.T_gt[k] @ np.linalg.inv(data.T_gt[k - 1]), np.eye(6) * 50)
            for m in obs_by_cam.get(k, []):
                lj = int(data.pt_idx[m])
                if lj not in lm_id:
                    lm_id[lj] = sm.add_landmark(data.pts_init[lj])
                sm.add_observation(i, lm_id[lj], data.obs[m], np.eye(3))
            _, info = sm.update()
            up.append((float(info.chi2), int(info.iterations)))
    _same_updates(ups[1], ups[0])
    _same_state(sms[1], sms[0])
    assert np.abs(sms[1].poses() - data.T_gt).max() < 0.05


def test_unported_and_invalid():
    sm = tinc.IncrementalSmoother(kind="se2", device="cpu")
    with pytest.raises(NotImplementedError, match="item 19"):
        sm.pose_marginals()
    with pytest.raises(ValueError, match="obs_kind"):
        sm.add_landmark(np.zeros(2))
    with pytest.raises(ValueError, match="landmark block"):
        sm.landmarks()
    with pytest.raises(ValueError, match="unsupported kind"):
        tinc.IncrementalSmoother(kind="so3", device="cpu")
    assert [tinc._bucket(n, 16) for n in (1, 16, 17, 25, 100)] == [jinc._bucket(n, 16) for n in (1, 16, 17, 25, 100)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            tinc.IncrementalSmoother(kind="se2")
