"""The camera models of the torch port (``pyslam_tpu_torch/sensors.py``)
against the JAX reference, in f64 on the CPU, on the same numpy inputs
from a seed.  Tolerance: 1e-12 relative to the largest reference entry
(the same expressions in the same order); validity masks are equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu import sensors as jsensors
from pyslam_tpu_torch import sensors as tsensors
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

CAMERAS = {
    "StereoCamera": dict(cu=321.5, cv=239.25, fu=505.0, fv=498.0, b=0.24, w=640, h=480),
    "RGBDCamera": dict(cu=321.5, cv=239.25, fu=505.0, fv=498.0, w=640, h=480),
}
BATCH_SHAPES = [(), (7,), (2, 5)]


def _close(out, ref):
    ref = np.asarray(ref)
    assert tuple(out.shape) == ref.shape and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def _points(shape, seed):
    rng = np.random.default_rng(seed)
    pt = rng.normal(size=shape + (3,))
    pt[..., 2] = 2.0 + 4.0 * rng.random(shape)
    return pt


@pytest.mark.parametrize("shape", BATCH_SHAPES)
@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_project_matches_reference(name, shape):
    jcam, tcam = getattr(jsensors, name)(**CAMERAS[name]), getattr(tsensors, name)(**CAMERAS[name])
    pt = _points(shape, 1)
    _close(tcam.project(torch.from_numpy(pt)), jcam.project(jnp.asarray(pt)))
    obs_t, jac_t = tcam.project(torch.from_numpy(pt), compute_jacobians=True)
    obs_j, jac_j = jcam.project(jnp.asarray(pt), compute_jacobians=True)
    _close(obs_t, obs_j)
    _close(jac_t, jac_j)
    assert jac_t.shape == shape + (3, 3)


@pytest.mark.parametrize("shape", BATCH_SHAPES)
@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_triangulate_matches_reference_and_inverts_project(name, shape):
    jcam, tcam = getattr(jsensors, name)(**CAMERAS[name]), getattr(tsensors, name)(**CAMERAS[name])
    pt = _points(shape, 2)
    obs = np.array(jcam.project(jnp.asarray(pt)))
    _close(tcam.triangulate(torch.from_numpy(obs)), jcam.triangulate(jnp.asarray(obs)))
    pt_t, jac_t = tcam.triangulate(torch.from_numpy(obs), compute_jacobians=True)
    pt_j, jac_j = jcam.triangulate(jnp.asarray(obs), compute_jacobians=True)
    _close(pt_t, pt_j)
    _close(jac_t, jac_j)
    np.testing.assert_allclose(pt_t.numpy(), pt, atol=1e-12)
    # the two Jacobians are inverses of each other at corresponding points
    _, jac_p = tcam.project(pt_t, compute_jacobians=True)
    eye = np.broadcast_to(np.eye(3), shape + (3, 3))
    np.testing.assert_allclose((jac_p @ jac_t).numpy(), eye, atol=1e-9)


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_is_valid_measurement_matches_reference(name):
    jcam, tcam = getattr(jsensors, name)(**CAMERAS[name]), getattr(tsensors, name)(**CAMERAS[name])
    rng = np.random.default_rng(3)
    obs = rng.uniform(-100.0, 800.0, size=(4, 50, 3))
    obs[..., 2] = rng.normal(size=(4, 50))
    obs[0, :4] = [[0.0, 0.0, 1.0], [640.0, 10.0, 1.0], [10.0, 480.0, 1.0], [10.0, 10.0, 0.0]]  # the edges
    out = tcam.is_valid_measurement(torch.from_numpy(obs))
    ref = np.asarray(jcam.is_valid_measurement(jnp.asarray(obs)))
    assert out.dtype == torch.bool and out.numpy().tolist() == ref.tolist()
    assert ref.any() and not ref.all()
    assert out[0, :4].tolist() == [True, False, False, False]


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_is_a_frozen_record_of_python_numbers(name):
    """The intrinsics stay Python numbers (no tensor, so no copy to the
    device in a call), field for field the reference's, and the output
    follows the input's dtype."""
    jcam, tcam = getattr(jsensors, name)(**CAMERAS[name]), getattr(tsensors, name)(**CAMERAS[name])
    assert dataclasses.asdict(tcam) == dataclasses.asdict(jcam)
    assert all(isinstance(v, (int, float)) for v in dataclasses.asdict(tcam).values())
    with pytest.raises(dataclasses.FrozenInstanceError):
        tcam.fu = 1.0
    pt = torch.from_numpy(_points((3,), 4)).float()
    assert tcam.project(pt).dtype == torch.float32
    defaults = getattr(tsensors, name)(**{k: v for k, v in CAMERAS[name].items() if k not in ("w", "h")})
    assert (defaults.w, defaults.h) == (0, 0)


def test_point_behind_the_camera_is_not_clamped():
    """z = 0 gives inf / NaN and z < 0 a mirrored pixel, as in the
    reference: no clamp is added."""
    tcam, jcam = tsensors.StereoCamera(**CAMERAS["StereoCamera"]), jsensors.StereoCamera(**CAMERAS["StereoCamera"])
    pt = np.array([[0.5, -0.25, 0.0], [0.5, -0.25, -2.0]])
    out, ref = tcam.project(torch.from_numpy(pt)).numpy(), np.asarray(jcam.project(jnp.asarray(pt)))
    assert not np.isfinite(out[0]).any() and not np.isfinite(ref[0]).any()
    np.testing.assert_array_equal(out[1], ref[1])
    assert out[1, 2] < 0  # a negative disparity
