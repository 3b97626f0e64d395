"""The twin of ``tests/test_integration.py``: the scaled-down
``examples/stereo_slam.py`` (24 frames, seed 1) end to end on the port,
``testing.stereo_slam`` over ``testing.stereo_slam_world``: the RANSAC
odometry chain, loop closures, the pose graph, then joint SLAM.

Held here: ``TestStereoSlamPipeline::test_loop_closure_improves_ate``, with
the reference test's own bounds (every ATE finite, the pose graph better
than odometry, joint SLAM better than the pose graph), in f32 and f64.  The
port's RANSAC draws its samples from a ``torch.Generator`` and the
reference's from JAX, so the two runs' ATEs are not the same numbers; the
whole example at its own size, each RANSAC call given the reference's
samples, is held to the reference's ATEs within 1e-2 by
``test_torch_ransac.py::test_stereo_slam_on_reference_samples_reaches_the_references_ate``,
and its data to the example's by
``test_torch_ransac.py::test_stereo_slam_world_is_the_examples``.
"""

import numpy as np
import pytest
import torch

from pyslam_tpu_torch import testing
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_loop_closure_improves_ate(dtype):
    out = testing.stereo_slam(*testing.stereo_slam_world(n_frames=24, seed=1), dtype=dtype, device="cpu")
    ate_odo, ate_opt, ate_joint = out["ate_odometry"], out["ate_pose_graph"], out["ate_joint"]
    assert np.isfinite([ate_odo, ate_opt, ate_joint]).all()
    assert ate_opt < ate_odo, f"pose-graph optimization must improve ATE ({ate_opt} vs {ate_odo})"
    assert ate_joint < ate_opt, f"joint SLAM must improve on the pose graph ({ate_joint} vs {ate_opt})"
    assert out["edges"] > 23  # the odometry chain and at least one loop closure
