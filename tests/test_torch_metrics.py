"""The twin of ``tests/test_metrics.py``: the reference's own trajectories
through the port's ``eval`` and the JAX package's, in f64 on the CPU.
Every number within 1e-12 of the reference's (relative to its size, at
least 1) and under the reference test's own bounds.

Held here: ``TestTrajectoryMetrics::test_zero_error_on_identical``,
``::test_known_offset``, ``::test_rel_errors_perfect_odometry``,
``::test_segment_errors``, ``::test_align_rigid``,
``::test_align_similarity_recovers_scale``, ``::test_align_none_and_unknown``;
``TestVisualizer::test_all_plots_render`` (each plot written to its file);
``TestTrajectorySync::test_associate_nearest_within_tolerance``,
``::test_associate_respects_max_dt_and_uniqueness``, ``::test_associate_offset``,
``::test_interpolate_midpoint_geodesic``, ``::test_end_to_end_sync_then_metrics``.

Held by ``tests/test_torch_eval.py`` (random SE(2) and SE(3) trajectories
against the reference):
  * ``TestTrajectoryMetrics::test_error_is_se3_log``, ``::test_cum_dists``,
    ``::test_se2_support``: ``test_torch_eval.py::test_paths_and_errors_match_reference``;
  * ``TestTrajectoryMetrics::test_convention_inversion``:
    ``test_torch_eval.py::test_convention_and_shapes``;
  * ``TestTrajectoryMetrics::test_save_load`` (pkl, mat):
    ``test_torch_eval.py::test_files_load_across_packages`` (each package
    reads the other's files);
  * ``TestTrajectorySync::test_interpolate_at_knots_exact``,
    ``::test_interpolate_out_of_range_raises``:
    ``test_torch_eval.py::test_interpolate_poses_matches_reference`` (knots,
    stamps outside the range raising, and ``extrapolate=True``).
"""

import numpy as np
import pytest
import torch

from pyslam_tpu.eval import TrajectoryMetrics as JaxMetrics
from pyslam_tpu.eval import TrajectoryVisualizer as JaxVisualizer
from pyslam_tpu.eval import associate as jax_associate
from pyslam_tpu.eval import interpolate_poses as jax_interpolate
from pyslam_tpu.lie import se3 as jse3
from pyslam_tpu_torch.eval import TrajectoryMetrics, TrajectoryVisualizer, associate, interpolate_poses
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

TOL = 1e-12


def _close(out, ref, tol=TOL):
    out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def straight_traj(n=50, step=1.0):
    """Ground truth going straight down +x."""
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, 0, 3] = step * np.arange(n)
    return T


def _pair(gt, est, **kw):
    return TrajectoryMetrics(gt, est, device="cpu", **kw), JaxMetrics(gt, est, **kw)


def test_zero_error_on_identical():
    T = straight_traj()
    tm, ref = _pair(T, T.copy())
    trans, rot = tm.traj_errors()
    assert trans.max().item() < 1e-12 and rot.max().item() < 1e-12
    assert float(tm.endpoint_error()) < 1e-12 and float(tm.armse("trans")) < 1e-12
    for a, b in zip(tm.traj_errors(), ref.traj_errors()):
        _close(a, b)


def test_known_offset():
    T = straight_traj()
    T_est = T.copy()
    T_est[:, 1, 3] += 0.5  # constant 0.5 m lateral offset
    tm, ref = _pair(T, T_est)
    _close(tm.traj_errors("trans"), np.full(50, 0.5))
    for name, want in (("mean_err", 0.5), ("rms_err", 0.5), ("cum_err", 25.0), ("armse", 0.5)):
        _close(getattr(tm, name)("trans"), want, 1e-10)
        _close(getattr(tm, name)("trans"), getattr(ref, name)("trans"))


def test_rel_errors_perfect_odometry():
    """A trajectory with a constant offset has no relative error."""
    T = straight_traj()
    T_est = T.copy()
    T_est[:, 1, 3] += 5.0
    tm, ref = _pair(T, T_est)
    trans, rot = tm.rel_errors()
    assert trans.max().item() < 1e-12
    for a, b in zip((trans, rot), ref.rel_errors()):
        _close(a, b)


def test_segment_errors():
    T = straight_traj(101)  # a 100 m path
    T_est = T.copy()
    T_est[:, 0, 3] *= 1.01  # 1% along-track drift
    tm, ref = _pair(T, T_est)
    mse = tm.mean_segment_errors([10.0, 50.0])
    assert mse.shape[0] == 2
    np.testing.assert_allclose(np.asarray(mse)[:, 1], 0.01, rtol=0.05)
    _close(mse, ref.mean_segment_errors([10.0, 50.0]))


def test_align_rigid():
    rng = np.random.default_rng(5)
    T = np.array(jse3.exp(rng.normal(0, 0.3, (40, 6))))
    T[:, :3, 3] += np.cumsum(rng.normal(0, 1.0, (40, 3)), axis=0)
    A = np.asarray(jse3.exp(np.array([3.0, -1.0, 2.0, 0.4, 0.2, -0.3])))
    tm, ref = _pair(T, A[None] @ T)
    assert float(tm.armse("trans")) > 1.0
    aligned, ref_aligned = tm.align("se3"), ref.align("se3")
    assert float(aligned.armse("trans")) < 1e-5
    assert abs(float(aligned.alignment["scale"]) - 1.0) < 1e-12
    _close(aligned.Twv_est, ref_aligned.Twv_est, 1e-10)


def test_align_similarity_recovers_scale():
    """A scaled and moved estimate (monocular scale): se3 alignment cannot
    zero the error, sim3 does and finds the scale."""
    rng = np.random.default_rng(6)
    T = straight_traj(40)
    T[:, :3, 3] += rng.normal(0, 0.5, (40, 3))
    T_est = T.copy()
    T_est[:, :3, 3] *= 2.5
    tm, ref = _pair(T, T_est)
    assert float(tm.align("se3").armse("trans")) > 1.0
    aligned = tm.align("sim3")
    assert float(aligned.armse("trans")) < 1e-6
    np.testing.assert_allclose(float(aligned.alignment["scale"]), 1 / 2.5, rtol=1e-9)
    _close(aligned.alignment["scale"], ref.align("sim3").alignment["scale"])


def test_align_none_and_unknown():
    T = straight_traj(10)
    tm, _ = _pair(T, T.copy())
    assert tm.align("none") is tm
    with pytest.raises(ValueError, match="unknown alignment"):
        tm.align("procrustes")


def test_all_plots_render(tmp_path):
    T = straight_traj(60)
    rng = np.random.default_rng(2)
    T_est = np.asarray(jse3.exp(rng.normal(0, 0.02, (60, 6)))) @ T
    viz = TrajectoryVisualizer({"run": TrajectoryMetrics(T, T_est, device="cpu")})
    ref = JaxVisualizer({"run": JaxMetrics(T, T_est)})
    plots = {"topdown": ("plot_topdown", ()), "seg": ("plot_segment_errors", ([10.0, 20.0],)),
             "norm": ("plot_norm_err", ()), "cum": ("plot_cum_norm_err", ())}
    for name, (fn, args) in plots.items():
        getattr(viz, fn)(*args, outfile=str(tmp_path / f"{name}.png"))
        getattr(ref, fn)(*args, outfile=str(tmp_path / f"{name}_ref.png"))
        assert (tmp_path / f"{name}.png").stat().st_size > 1000


def _associated(t_ref, t_est, **kw):
    i, j = associate(t_ref, t_est, **kw)
    i_ref, j_ref = jax_associate(t_ref, t_est, **kw)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_array_equal(j, j_ref)
    return i, j


def test_associate_nearest_within_tolerance():
    t_ref = np.arange(0.0, 1.0, 0.1)
    t_est = t_ref + np.random.default_rng(0).uniform(-0.015, 0.015, t_ref.shape)
    i, j = _associated(t_ref, t_est, max_dt=0.02)
    assert len(i) == len(t_ref)
    np.testing.assert_array_equal(i, j)


def test_associate_respects_max_dt_and_uniqueness():
    i, j = _associated(np.array([0.0, 1.0, 2.0]), np.array([0.005, 0.009, 5.0]), max_dt=0.02)
    assert len(i) == 1 and i[0] == 0 and j[0] == 0  # one stamp claims 0.0; the far one matches nothing


def test_associate_offset():
    i, _ = _associated(np.array([10.0, 11.0]), np.array([0.0, 1.0]), max_dt=0.01, offset=10.0)
    assert len(i) == 2


def test_interpolate_midpoint_geodesic():
    xi = np.array([0.3, -0.2, 0.5, 0.2, -0.1, 0.15])
    T = np.stack([np.eye(4), np.asarray(jse3.exp(xi[None]))[0]])
    Tm = interpolate_poses(T, [0.0, 1.0], [0.5], device="cpu")[0]
    _close(Tm, np.asarray(jse3.exp(0.5 * xi[None]))[0], 1e-9)
    _close(Tm, jax_interpolate(T, [0.0, 1.0], [0.5])[0])


def test_end_to_end_sync_then_metrics():
    """Trajectories at two rates: ground truth interpolated at the
    estimate's stamps, then the ATE."""
    t_gt = np.linspace(0.0, 10.0, 101)
    rate = np.array([0.1, 0.02, 0.0, 0.0, 0.0, 0.05])
    T_gt = np.asarray(jse3.exp(t_gt[:, None] * rate[None]))
    t_est = np.linspace(0.3, 9.7, 48)
    T_est = np.asarray(jse3.exp(t_est[:, None] * rate[None]))
    T_gt_at_est = interpolate_poses(T_gt, t_gt, t_est, device="cpu")
    _close(T_gt_at_est, jax_interpolate(T_gt, t_gt, t_est))
    tm = TrajectoryMetrics(T_gt_at_est, T_est, convention="Twv", device="cpu")
    assert float(tm.armse("trans")) < 1e-6
