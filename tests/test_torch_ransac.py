"""The port's frame-to-frame RANSAC against the JAX reference: ``kabsch``,
the scorer given the reference's samples (T within 1e-10 in float64, the
same inlier masks), the whole ``compute_transform`` with and without the
pixel-space polish; the port's own draw; and ``examples/stereo_slam.py``
on the port (``testing.stereo_slam``) with its data generator."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.lie import se3 as jse3
from pyslam_tpu.pipelines.ransac import FrameToFrameRANSAC as JaxRANSAC
from pyslam_tpu.pipelines.ransac import _ransac_batched
from pyslam_tpu.pipelines.ransac import kabsch as jax_kabsch
from pyslam_tpu.sensors import StereoCamera as JaxStereo
from pyslam_tpu_torch import testing
from pyslam_tpu_torch.pipelines.ransac import FrameToFrameRANSAC, draw_samples, kabsch, ransac_from_samples
from pyslam_tpu_torch.sensors import StereoCamera
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM_ARGS = dict(cu=320.0, cv=240.0, fu=500.0, fv=500.0, b=0.3, w=640, h=480)
JCAM, CAM = JaxStereo(**CAM_ARGS), StereoCamera(**CAM_ARGS)


def make_scene(n=120, seed=0, outlier_frac=0.0, pix_noise=0.0):
    """``tests/test_ransac.py``'s scene: points 2 to 8 m ahead, a known
    motion, optional pixel noise and gross outliers."""
    rng = np.random.default_rng(seed)
    P1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 8, n)], axis=-1)
    T_21 = np.asarray(jse3.exp(jnp.asarray([0.1, -0.05, 0.2, 0.02, -0.03, 0.05])))
    P2 = P1 @ T_21[:3, :3].T + T_21[:3, 3]
    obs_1 = CAM.project(torch.from_numpy(P1)).numpy()
    obs_2 = CAM.project(torch.from_numpy(P2)).numpy()
    vis = CAM.is_valid_measurement(torch.from_numpy(obs_1)).numpy() & CAM.is_valid_measurement(
        torch.from_numpy(obs_2)).numpy()
    obs_1, obs_2 = obs_1[vis], obs_2[vis]
    n = len(obs_1)
    if pix_noise > 0:
        obs_1 += rng.normal(0, pix_noise, obs_1.shape)
        obs_2 += rng.normal(0, pix_noise, obs_2.shape)
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        obs_2[idx, :2] += rng.uniform(30, 120, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return obs_1, obs_2, T_21, n_out


def _reference_samples(n, num_iters, seed=0):
    """The draw of the reference's ``_ransac_batched``."""
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (num_iters, 3), 0, n))


# ---- kabsch ----


@pytest.mark.parametrize("case", ["single", "batched", "coplanar", "weighted"])
def test_kabsch_matches_reference(case, rng):
    shape = (7, 5, 3) if case == "batched" else (30, 3)
    P = rng.normal(0, 2, shape)
    if case == "coplanar":  # a reflection tempts; det R must stay +1
        P[..., 2] = 0.0
    T = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.3, shape[:-2] + (6,)))))
    Q = np.einsum("...ij,...nj->...ni", T[..., :3, :3], P) + T[..., None, :3, 3] + rng.normal(0, 0.01, shape)
    w = rng.uniform(0.1, 1.0, shape[:-1]) if case == "weighted" else None
    ref = np.asarray(jax_kabsch(jnp.asarray(P), jnp.asarray(Q), None if w is None else jnp.asarray(w)))
    out = kabsch(torch.from_numpy(P), torch.from_numpy(Q), None if w is None else torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10)
    assert np.all(np.linalg.det(out[..., :3, :3]) > 0.99)


# ---- the scorer and the whole estimate, on the reference's samples ----


@pytest.mark.parametrize("scene", [dict(), dict(outlier_frac=0.35, pix_noise=0.3, seed=4)], ids=["clean", "outliers"])
def test_scorer_on_reference_samples_matches_reference(scene):
    obs_1, obs_2, _, _ = make_scene(**scene)
    M, thresh = 128, 2.0
    samples = _reference_samples(len(obs_1), M)
    T_ref, mask_ref, n_ref = _ransac_batched(JCAM, jnp.asarray(obs_1), jnp.asarray(obs_2), M, thresh,
                                             jax.random.PRNGKey(0))
    T, mask, n = ransac_from_samples(CAM, torch.from_numpy(obs_1), torch.from_numpy(obs_2),
                                     torch.from_numpy(samples).long(), thresh)
    np.testing.assert_allclose(T.numpy(), np.asarray(T_ref), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_ref))
    assert int(n) == int(n_ref)


@pytest.mark.parametrize("polish", [False, True])
def test_compute_transform_on_reference_samples_matches_reference(polish):
    obs_1, obs_2, T_true, n_out = make_scene(outlier_frac=0.35, pix_noise=0.3, seed=4)
    ref_T, ref_mask = JaxRANSAC(JCAM, num_iters=512, polish=polish).compute_transform(obs_1, obs_2)
    T, mask = FrameToFrameRANSAC(CAM, num_iters=512, polish=polish, device="cpu").compute_transform(
        obs_1, obs_2, samples=_reference_samples(len(obs_1), 512))
    assert mask.dtype == bool
    np.testing.assert_allclose(T.mat.numpy(), np.asarray(ref_T.mat), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(mask, np.asarray(ref_mask))


def test_own_draw_recovers_the_motion():
    """The port's own samples (a ``torch.Generator`` seeded with ``seed``):
    the clean scene exactly, the outlier scene as the reference's test
    holds it."""
    obs_1, obs_2, T_true, _ = make_scene()
    T, mask = FrameToFrameRANSAC(CAM, device="cpu").compute_transform(obs_1, obs_2)
    np.testing.assert_allclose(T.mat.numpy(), T_true, atol=1e-6)
    assert mask.sum() == len(obs_1)
    obs_1, obs_2, T_true, n_out = make_scene(outlier_frac=0.35, pix_noise=0.3, seed=4)
    T, mask = FrameToFrameRANSAC(CAM, num_iters=512, device="cpu").compute_transform(obs_1, obs_2)
    xi = np.asarray(jse3.log(jnp.asarray(np.linalg.inv(T_true) @ T.mat.numpy())))
    assert np.linalg.norm(xi[:3]) < 0.02 and np.linalg.norm(xi[3:]) < 0.01
    assert len(obs_1) - n_out - 3 <= mask.sum() <= len(obs_1) - n_out + 3


def test_draw_is_seeded():
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    a, b = (draw_samples(50, 64, g) for g in gens)
    assert a.shape == (64, 3) and torch.equal(a, b) and 0 <= a.min() and a.max() < 50


# ---- examples/stereo_slam.py on the port ----


def test_stereo_slam_world_is_the_examples():
    """The data of ``examples/stereo_slam.py`` (its world, poses and noisy
    observations; the port projects in float64 on the host, the example
    through JAX, here with x64 on)."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import stereo_slam as ex

    world, gt, frames = testing.stereo_slam_world(n_frames=12, seed=3)
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(world, ex.make_world(rng))
    ref_gt = [ex.gt_pose(k, 12) for k in range(12)]
    np.testing.assert_array_equal(gt, np.stack(ref_gt))
    for (ids, obs), T in zip(frames, ref_gt):
        ids_r, obs_r = ex.observe(T, world, rng)
        np.testing.assert_array_equal(ids, ids_r)
        np.testing.assert_allclose(obs, obs_r, rtol=0, atol=1e-9)
    assert testing.SLAM_CAM == {k: getattr(ex.CAM, k) for k in testing.SLAM_CAM}


def test_stereo_slam_on_reference_samples_reaches_the_references_ate():
    """The whole example at its size (40 frames, 4,000 points) in float32 on
    the CPU, each RANSAC call given the reference's samples
    (``chip_smoke_refs.npz``, ``scripts/torch_port_refs.py --phases 48``):
    the ATE of each stage within 1e-2 of the reference's (measured 1.2e-5,
    4.5e-4 and 2.7e-3)."""
    refs = np.load(os.path.join(ROOT, "chip_smoke_refs.npz"))
    samples = dict(zip(refs["p48_sample_counts"].tolist(), refs["p48_samples"]))
    out = testing.stereo_slam(*testing.stereo_slam_world(), device="cpu", samples=samples)
    ate = np.array([out["ate_odometry"], out["ate_pose_graph"], out["ate_joint"]])
    np.testing.assert_allclose(ate, refs["p48_ate"], rtol=1e-2)
    assert (out["edges"], out["landmarks"], out["observations"]) == (40, 3910, 12000)
