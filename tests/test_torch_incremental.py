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
from pyslam_tpu_torch.testing import drive_incremental, drive_incremental_landmarks
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)


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


@pytest.mark.parametrize("keep_window", [None, 10])
def test_landmark_stream_matches_reference(keep_window):
    """Bearing-range landmark SLAM through ``solve_auto`` (the Schur routes,
    ``schur_sparse_pair_budget=0``); with ``keep_window`` the carried
    priors span poses and landmarks and the graph takes the dense path."""
    data = jsynth.landmark_slam_2d(n_poses=22, n_landmarks=12, max_range=9.0, obs_type="bearing_range", seed=8)
    jsm, tsm = _pair(dict(method="lm", max_iters=15), kind="se2", obs_kind="bearing_range_se2")
    t_ups = drive_incremental_landmarks(tsm, data, 6, keep_window)
    j_ups = drive_incremental_landmarks(jsm, data, 6, keep_window)
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


def _branch_spy(monkeypatch):
    """The names of the covariance functions ``pose_marginals`` calls."""
    from pyslam_tpu_torch.solver import covariance as tcov

    called = []
    for name in ("marginal_covariances_direct", "pose_marginal_covariances", "full_covariance"):
        fn = getattr(tcov, name)
        monkeypatch.setattr(tcov, name, lambda *a, _fn=fn, _name=name, **kw: called.append(_name) or _fn(*a, **kw))
    return called


def _same_marginals(tsm, jsm, rel=1e-7):
    """The two smoothers' states agree within 1e-9; their marginals, which
    depend smoothly on the state, within ``rel`` of the largest entry."""
    ours, ref = tsm.pose_marginals(), np.asarray(jsm.pose_marginals())
    assert ours.shape == ref.shape == (tsm.n, tsm._dof, tsm._dof)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * np.abs(ref).max())
    np.testing.assert_allclose(ours[0], np.eye(tsm._dof), atol=1e-9)  # the gauge anchor
    return ours


def test_pose_marginals_direct_branch_matches_reference(monkeypatch):
    """A pose graph: the selected inverse of the multifrontal factors, before
    and after ``marginalize_oldest`` (the dense prior's slots all name
    'poses', so it stays on this branch)."""
    data = jsynth.se2_loop(n_poses=40, n_loops=6, seed=2)
    jsm, tsm = _pair(dict(method="lm", max_iters=15), kind="se2")
    for sm in (jsm, tsm):
        drive_incremental(sm, data, every=10)
    called = _branch_spy(monkeypatch)
    _same_marginals(tsm, jsm)
    for sm in (jsm, tsm):
        sm.marginalize_oldest(keep_last=10)
        sm.update()
    assert [fb.slots for fb in tsm._prior_batches] == [("poses", "poses")]
    _same_marginals(tsm, jsm)
    assert called == ["marginal_covariances_direct"] * 2


def test_pose_marginals_schur_branch_matches_reference(monkeypatch):
    """A landmark graph: S-solves on the reduced camera system."""
    data = jsynth.landmark_slam_2d(n_poses=22, n_landmarks=12, max_range=9.0, obs_type="bearing_range", seed=8)
    jsm, tsm = _pair(dict(method="lm", max_iters=15), kind="se2", obs_kind="bearing_range_se2")
    drive_incremental_landmarks(tsm, data, 6)
    drive_incremental_landmarks(jsm, data, 6)
    called = _branch_spy(monkeypatch)
    _same_marginals(tsm, jsm)
    assert called == ["pose_marginal_covariances"]


def test_pose_marginals_dense_branch_matches_reference(monkeypatch):
    """A landmark graph carrying a marginalization prior over poses and
    landmarks: the dense inverse."""
    data = jsynth.landmark_slam_2d(n_poses=22, n_landmarks=12, max_range=9.0, obs_type="bearing_range", seed=8)
    jsm, tsm = _pair(dict(method="lm", max_iters=15), kind="se2", obs_kind="bearing_range_se2")
    drive_incremental_landmarks(tsm, data, 6, keep_window=10)
    drive_incremental_landmarks(jsm, data, 6, keep_window=10)
    assert any({"poses", "landmarks"} <= set(fb.slots) for fb in tsm._prior_batches)
    called = _branch_spy(monkeypatch)
    _same_marginals(tsm, jsm)
    assert called == ["full_covariance"]


def test_unported_and_invalid():
    sm = tinc.IncrementalSmoother(kind="se2", device="cpu")
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
