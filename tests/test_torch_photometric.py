"""The port's photometric factor kernels and residual object against the JAX
reference, on the same numpy inputs in float64: r and J within 1e-12 of
the largest entry, for one factor and for a batch of three (each with its
own tracking image), through the corner-packed and the four-gather
sampling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.graph.core import FACTOR_KERNELS as JAX_KERNELS
from pyslam_tpu.lie import se3 as jse3
from pyslam_tpu.pipelines import PhotometricResidualSE3 as JaxResidual
from pyslam_tpu.sensors import RGBDCamera as JaxRGBD
from pyslam_tpu.sensors import StereoCamera as JaxStereo
from pyslam_tpu.utils import pack_corners as jax_pack
from pyslam_tpu_torch.graph.core import FACTOR_KERNELS
from pyslam_tpu_torch.lie import se3
from pyslam_tpu_torch.pipelines import PhotometricResidualSE3
from pyslam_tpu_torch.sensors import RGBDCamera, StereoCamera
from pyslam_tpu_torch.testing import PLANE_CAM, render_rgbd, render_stereo
from pyslam_tpu_torch.utils import pack_corners
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

TOL = 1e-12
KINDS = ["photometric_se3", "photometric_affine_se3"]


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def _poses(F, seed):
    """F poses near the identity; the last moves half the plane out of view."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, [0.02, 0.02, 0.01, 0.004, 0.004, 0.004], (F, 6))
    if F > 1:
        xi[-1, 0] = 1.5
    return jse3.exp(jnp.asarray(xi)), np.array(jse3.exp(jnp.asarray(xi)))


def _data(F, stereo, seed=0):
    """F factors over one keyframe (a depth or disparity map with a dead
    band), each against a tracking frame of its own at another pose."""
    rng = np.random.default_rng(seed)
    if stereo:
        im, _, dd = render_stereo(np.zeros(3))
        jcam, tcam = JaxStereo(b=0.3, **PLANE_CAM), StereoCamera(b=0.3, **PLANE_CAM)
    else:
        im, dd = render_rgbd(np.zeros(3))
        jcam, tcam = JaxRGBD(**PLANE_CAM), RGBDCamera(**PLANE_CAM)
    dd = dd.copy()
    dd[:5] = np.nan
    res = JaxResidual(jcam, im, dd, im, stiffness=1.0)
    tracks = np.stack([render_rgbd(rng.normal(0, 0.03, 3))[0] for _ in range(F)])
    host = dict(pt_ref=np.repeat(np.asarray(res.pt_ref)[None], F, 0), I_ref=np.repeat(np.asarray(res.I_ref)[None], F, 0),
                mask=np.repeat(np.asarray(res.mask, np.float64)[None], F, 0), im_track=tracks,
                stiffness=rng.uniform(1.0, 4.0, F))
    jdata = {k: jnp.asarray(v) for k, v in host.items()}
    tdata = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}
    jdata["camera"], tdata["camera"] = jcam, tcam
    return jdata, tdata


def _pack(jdata, tdata):
    jdata = dict(jdata, im_track4=jax.vmap(jax_pack)(jdata["im_track"]))
    tdata = dict(tdata, im_track4=torch.func.vmap(pack_corners)(tdata["im_track"]))
    return jdata, tdata


@pytest.mark.parametrize("packed", [False, True], ids=["four_gathers", "packed"])
@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_reference(kind, F, packed):
    jdata, tdata = _data(F, stereo=(kind == "photometric_affine_se3"))
    if packed:
        jdata, tdata = _pack(jdata, tdata)
    jT, T = _poses(F, seed=F)
    r_ref, (J_ref,) = JAX_KERNELS[kind](jdata, jT, compute_jacobians=True)
    r, (J,) = FACTOR_KERNELS[kind](tdata, torch.from_numpy(T), compute_jacobians=True)
    _close(r, r_ref)
    _close(J, J_ref)
    r_only, none = FACTOR_KERNELS[kind](tdata, torch.from_numpy(T), compute_jacobians=False)
    assert none is None and torch.equal(r_only, r)


@pytest.mark.parametrize("kind", KINDS)
def test_packed_sampling_gives_the_same_bits(kind):
    """The corner-packed gather and the four gathers are the same arithmetic,
    and a batch of factors the same as each factor alone."""
    jdata, tdata = _data(3, stereo=False, seed=4)
    _, T = _poses(3, seed=4)
    T = torch.from_numpy(T)
    r4, (J4,) = FACTOR_KERNELS[kind](tdata, T)
    r1, (J1,) = FACTOR_KERNELS[kind](_pack(jdata, tdata)[1], T)
    assert torch.equal(r4, r1) and torch.equal(J4, J1)
    for f in range(3):
        one = {k: (v[f:f + 1] if torch.is_tensor(v) else v) for k, v in tdata.items()}
        rf, (Jf,) = FACTOR_KERNELS[kind](one, T[f:f + 1])
        torch.testing.assert_close(rf, r4[f:f + 1], rtol=0, atol=1e-14)
        torch.testing.assert_close(Jf, J4[f:f + 1], rtol=0, atol=1e-14)


@pytest.mark.parametrize("kind", KINDS)
def test_jacobian_is_the_derivative_of_the_residual(kind):
    """The analytic J against forward-mode autodiff of the residual under a
    left perturbation (the affine kernel's gain and bias held fixed by
    ``.detach()``, the Kaufman approximation)."""
    _, tdata = _data(1, stereo=False, seed=2)
    tdata["im_track"] = 1.2 * tdata["im_track"] + 0.05
    _, T = _poses(1, seed=2)
    T = torch.from_numpy(T)
    _, (J,) = FACTOR_KERNELS[kind](tdata, T)

    def r_of(eps):
        return FACTOR_KERNELS[kind](tdata, se3.exp(eps[None]) @ T, compute_jacobians=False)[0][0]

    J_ad = torch.func.jacfwd(r_of)(torch.zeros(6, dtype=torch.float64))
    torch.testing.assert_close(J[0], J_ad, rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_nan_pose_gives_nan_residuals(kind):
    """A NaN trial pose (a failed factorization's step) samples NaN, as the
    reference's clamped gather does, and raises nothing: the LM loop then
    rejects the step on its NaN cost."""
    _, tdata = _data(1, stereo=False)
    T = torch.full((1, 4, 4), float("nan"), dtype=torch.float64)
    r, (J,) = FACTOR_KERNELS[kind](tdata, T)
    assert torch.isnan(r.sum()) and torch.isnan(J.sum())


@pytest.mark.parametrize("stereo", [False, True], ids=["rgbd", "stereo"])
@pytest.mark.parametrize("min_grad", [0.0, 0.01])
def test_residual_object_matches_reference(stereo, min_grad):
    if stereo:
        im, _, dd = render_stereo(np.zeros(3))
        jcam, tcam = JaxStereo(b=0.3, **PLANE_CAM), StereoCamera(b=0.3, **PLANE_CAM)
    else:
        im, dd = render_rgbd(np.zeros(3))
        jcam, tcam = JaxRGBD(**PLANE_CAM), RGBDCamera(**PLANE_CAM)
    dd = dd.copy()
    dd[:, :4] = np.nan
    im_track, _ = render_rgbd(np.array([0.05, -0.03, 0.02]))
    ref = JaxResidual(jcam, im, dd, im_track, stiffness=2.0, min_grad=min_grad)
    out = PhotometricResidualSE3(tcam, im, dd, im_track, stiffness=2.0, min_grad=min_grad)
    for key in ("pt_ref", "I_ref", "mask"):
        np.testing.assert_array_equal(out.batch_data()[key], np.asarray(ref.batch_data()[key]), err_msg=key)
    jT, T = _poses(1, seed=7)
    r_ref, (J_ref,) = ref.evaluate([jT[0]], compute_jacobians=[True])
    r, (J,) = out.evaluate([torch.from_numpy(T[0])], compute_jacobians=[True])
    _close(r, r_ref)
    _close(J, J_ref)
    _close(out.evaluate([torch.from_numpy(T[0])]), ref.evaluate([jT[0]]))
