"""Dense photometric residual.

Counterpart of ``pyslam_tpu/pipelines/photometric.py``: the factor kernels
``photometric_se3`` and ``photometric_affine_se3`` and the residual object
``PhotometricResidualSE3``. One factor is one keyframe-to-frame
photometric constraint over P pixels:

    r_p = stiffness * ( I_track( proj(T * pt_ref_p) ) - I_ref(p) )

with the analytic Jacobian chained through the bilinear image gradients,
the camera's projection Jacobian and the SE(3) odot operator. Pixels are
never compacted: an invalid or out-of-bounds pixel has residual and
Jacobian 0, so the shapes stay fixed from frame to frame.

The F factors of a batch sample their own tracking images: one call of
``utils.bilinear_interpolate_packed`` (one gather of a corner-packed row a
pixel, ``utils.pack_corners``, where the data holds the packed images as
the pipelines' do) or ``utils.bilinear_interpolate`` (the reference's data,
``PhotometricResidualSE3``'s) when F is 1, ``torch.func.vmap`` of it over
the factors otherwise. The residual-only
path samples no image gradient and forms no projection Jacobian.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.core import register_factor
from ..lie import se3
from ..residuals import _ResidualBase
from ..utils import bilinear_interpolate, bilinear_interpolate_packed


def _sample(data, u, v, need_grad):
    """Bilinear samples (and d/du, d/dv with ``need_grad``) of each factor's
    tracking image at its (P,) pixel coordinates: (F, P) each."""
    im = data["im_track"]
    H, W = im.shape[-2], im.shape[-1]
    if "im_track4" in data:
        src = data["im_track4"]

        def one(im4_f, u_f, v_f):
            return bilinear_interpolate_packed(im4_f, H, W, u_f, v_f, need_grad)
    else:
        src = im

        def one(im_f, u_f, v_f):
            return bilinear_interpolate(im_f, u_f, v_f, need_grad)

    if src.shape[0] == 1:
        out = one(src[0], u[0], v[0])
        return tuple(o[None] for o in out) if need_grad else out[None]
    return torch.func.vmap(one)(src, u, v)


def _warp_and_sample(data, T, need_jac):
    """Shared warp and sampling stage of the photometric kernels: returns
    (I_w, gu, gv, valid, cam_jac, p_safe); gu, gv and cam_jac are None
    without Jacobians."""
    cam = data["camera"]
    pt_ref, mask = data["pt_ref"], data["mask"]
    im = data["im_track"]
    H, W = im.shape[-2], im.shape[-1]
    p_track = se3.act(T[:, None], pt_ref)  # (F, P, 3)
    z = p_track[..., 2]
    eps = 1e-6
    z_safe = torch.where(z > eps, z, 1.0)
    p_safe = torch.cat([p_track[..., :2], z_safe[..., None]], dim=-1)

    if need_jac:
        obs, cam_jac = cam.project(p_safe, compute_jacobians=True)
    else:
        obs, cam_jac = cam.project(p_safe), None
    u, v = obs[..., 0], obs[..., 1]
    in_bounds = (u >= 0.0) & (u <= W - 1.0) & (v >= 0.0) & (v <= H - 1.0)
    valid = mask.to(u.dtype) * in_bounds.to(u.dtype) * (z > eps).to(u.dtype)
    if need_jac:
        I_w, gu, gv = _sample(data, u, v, True)
    else:
        I_w, gu, gv = _sample(data, u, v, False), None, None
    return I_w, gu, gv, valid, cam_jac, p_safe


def _pose_jacobian(gu, gv, cam_jac, p_safe):
    """dI/dxi (F, P, 6): [gu, gv] . dproj_{u,v}/dp chained through odot(p)."""
    J_pix = gu[..., None] * cam_jac[..., 0, :] + gv[..., None] * cam_jac[..., 1, :]
    return (J_pix[..., :, None] * se3.odot(p_safe)).sum(-2)


@register_factor("photometric_se3")
def photometric_se3(data, T, compute_jacobians=True):
    """Batched dense photometric kernel.

    data (leading F = #factors, P = pixels per factor):
      pt_ref    (F, P, 3)   keyframe-frame 3D points (from depth / disparity)
      I_ref     (F, P)      reference intensities
      mask      (F, P)      static validity (depth valid, texture threshold)
      im_track  (F, H, W)   tracking image
      im_track4 (F, H*W, 4) optional: ``pack_corners`` of each tracking image
      stiffness (F,)        intensity inverse-noise scale
      camera                a ``sensors`` camera (shared)
    T: (F, 4, 4), T_track_ref. Returns r (F, P) and J (F, P, 6)."""
    I_w, gu, gv, valid, cam_jac, p_safe = _warp_and_sample(data, T, compute_jacobians)
    s = data["stiffness"][:, None] * valid
    r = s * (I_w - data["I_ref"])
    if not compute_jacobians:
        return r, None
    return r, (s[..., None] * _pose_jacobian(gu, gv, cam_jac, p_safe),)


@register_factor("photometric_affine_se3")
def photometric_affine_se3(data, T, compute_jacobians=True):
    """Photometric kernel with a per-factor affine illumination (gain a,
    bias b) eliminated by variable projection:

        r_p = s * ( a* I_w(p) + b* - I_ref(p) ),
        (a*, b*) = argmin_{a,b} sum_p valid_p (a I_w + b - I_ref)^2,

    a closed-form 2x2 solve per factor, so the illumination never enters
    the solver's state. The Jacobians hold (a*, b*) fixed (the Kaufman
    approximation: ``.detach()``), so autodiff of this kernel gives the
    analytic blocks."""
    I_ref = data["I_ref"]
    I_w, gu, gv, valid, cam_jac, p_safe = _warp_and_sample(data, T, compute_jacobians)
    w = valid
    Sw = torch.sum(w, dim=-1)
    S1 = torch.sum(w * I_w, dim=-1)
    S2 = torch.sum(w * I_w * I_w, dim=-1)
    Sr = torch.sum(w * I_ref, dim=-1)
    Sx = torch.sum(w * I_w * I_ref, dim=-1)
    det = S2 * Sw - S1 * S1
    ok = det > 1e-12 * torch.clamp(S2 * Sw, min=1.0)
    det_safe = torch.where(ok, det, 1.0)
    a = torch.where(ok, (Sx * Sw - S1 * Sr) / det_safe, 1.0).detach()[:, None]
    b = torch.where(ok, (S2 * Sr - S1 * Sx) / det_safe, 0.0).detach()[:, None]

    s = data["stiffness"][:, None] * valid
    r = s * (a * I_w + b - I_ref)
    if not compute_jacobians:
        return r, None
    return r, ((s * a)[..., None] * _pose_jacobian(gu, gv, cam_jac, p_safe),)


class PhotometricResidualSE3(_ResidualBase):
    """Dense direct residual over one keyframe-to-frame pair. Parameter:
    [T_track_ref (SE3)].

    ``depth_or_disp`` follows the camera's triangulate convention:
    disparity for a StereoCamera, depth for an RGBDCamera. ``min_grad``
    masks out weakly textured pixels without changing array shapes. The
    measurements are kept on the host in the dtype of ``im_ref``."""

    factor_kind = "photometric_se3"
    param_kinds = ("se3",)

    def __init__(self, camera, im_ref, depth_or_disp, im_track, stiffness, min_grad=0.0):
        self.camera = camera
        im_ref = np.asarray(im_ref)
        dt = im_ref.dtype
        dd = np.asarray(depth_or_disp, dt)
        self.im_track = np.asarray(im_track)
        Hh, Ww = im_ref.shape
        vv, uu = np.meshgrid(np.arange(Hh, dtype=dt), np.arange(Ww, dtype=dt), indexing="ij")
        obs = np.stack([uu, vv, dd], axis=-1).reshape(-1, 3)
        valid = camera.is_valid_measurement(torch.from_numpy(obs)).numpy() & np.isfinite(obs[:, 2])
        if min_grad > 0.0:
            gy, gx = np.gradient(im_ref)
            gmag = np.sqrt(gx * gx + gy * gy).reshape(-1)
            valid = valid & (gmag >= min_grad)
        obs_safe = np.where(valid[:, None], obs, np.asarray([0.0, 0.0, 1.0], dt))
        self.pt_ref = camera.triangulate(torch.from_numpy(obs_safe)).numpy()
        self.I_ref = im_ref.reshape(-1)
        self.mask = valid
        self.stiffness = float(stiffness)

    def batch_data(self):
        return {
            "camera": self.camera,
            "pt_ref": self.pt_ref,
            "I_ref": self.I_ref,
            "mask": self.mask,
            "im_track": self.im_track,
            "stiffness": self.stiffness,
        }


__all__ = ["PhotometricResidualSE3", "photometric_se3", "photometric_affine_se3"]
