"""Camera sensor models on torch tensors.

Counterpart of ``pyslam_tpu/sensors.py``: ``StereoCamera`` and
``RGBDCamera`` with ``project`` / ``triangulate`` (both with analytic 3x3
Jacobians) and validity masks.  The cameras are frozen dataclasses of
Python numbers: the intrinsics enter every expression as scalars, so no
call copies anything from the host to the device.  ``project`` and
``triangulate`` broadcast over any leading batch dims.
"""

from __future__ import annotations

import dataclasses

import torch


def _rows(*rows):
    """(..., 3, 3) from three rows of three (...,) tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _in_image(u, v, w, h):
    return (u >= 0.0) & (u < w) & (v >= 0.0) & (v < h)


@dataclasses.dataclass(frozen=True)
class StereoCamera:
    """Rectified stereo camera.  Observations are ``[u_left, v_left, disparity]``.

      project:     p=(x,y,z) -> [fu x/z + cu, fv y/z + cv, fu b / z]
      triangulate: [u,v,d]   -> z = fu b / d, x = (u-cu) z / fu, y = (v-cv) z / fv
    """

    cu: float
    cv: float
    fu: float
    fv: float
    b: float
    w: int = 0
    h: int = 0

    def project(self, pt, compute_jacobians: bool = False):
        x, y, z = pt[..., 0], pt[..., 1], pt[..., 2]
        one_over_z = 1.0 / z
        obs = torch.stack(
            [
                self.fu * x * one_over_z + self.cu,
                self.fv * y * one_over_z + self.cv,
                self.fu * self.b * one_over_z,
            ],
            dim=-1,
        )
        if not compute_jacobians:
            return obs
        zero = torch.zeros_like(x)
        oz2 = one_over_z * one_over_z
        jac = _rows(
            [self.fu * one_over_z, zero, -self.fu * x * oz2],
            [zero, self.fv * one_over_z, -self.fv * y * oz2],
            [zero, zero, -self.fu * self.b * oz2],
        )
        return obs, jac

    def triangulate(self, obs, compute_jacobians: bool = False):
        u, v, d = obs[..., 0], obs[..., 1], obs[..., 2]
        z = self.fu * self.b / d
        x = (u - self.cu) * z / self.fu
        y = (v - self.cv) * z / self.fv
        pt = torch.stack([x, y, z], dim=-1)
        if not compute_jacobians:
            return pt
        zero = torch.zeros_like(u)
        dz_dd = -self.fu * self.b / (d * d)
        jac = _rows(
            [z / self.fu, zero, (u - self.cu) / self.fu * dz_dd],
            [zero, z / self.fv, (v - self.cv) / self.fv * dz_dd],
            [zero, zero, dz_dd],
        )
        return pt, jac

    def is_valid_measurement(self, obs):
        u, v, d = obs[..., 0], obs[..., 1], obs[..., 2]
        return (d > 0.0) & _in_image(u, v, self.w, self.h)


@dataclasses.dataclass(frozen=True)
class RGBDCamera:
    """RGB-D camera.  Observations are ``[u, v, z]``.

      project:     p=(x,y,z) -> [fu x/z + cu, fv y/z + cv, z]
      triangulate: [u,v,z]   -> x = (u-cu) z / fu, y = (v-cv) z / fv
    """

    cu: float
    cv: float
    fu: float
    fv: float
    w: int = 0
    h: int = 0

    def project(self, pt, compute_jacobians: bool = False):
        x, y, z = pt[..., 0], pt[..., 1], pt[..., 2]
        one_over_z = 1.0 / z
        obs = torch.stack(
            [
                self.fu * x * one_over_z + self.cu,
                self.fv * y * one_over_z + self.cv,
                z,
            ],
            dim=-1,
        )
        if not compute_jacobians:
            return obs
        zero = torch.zeros_like(x)
        oz2 = one_over_z * one_over_z
        jac = _rows(
            [self.fu * one_over_z, zero, -self.fu * x * oz2],
            [zero, self.fv * one_over_z, -self.fv * y * oz2],
            [zero, zero, torch.ones_like(x)],
        )
        return obs, jac

    def triangulate(self, obs, compute_jacobians: bool = False):
        u, v, z = obs[..., 0], obs[..., 1], obs[..., 2]
        x = (u - self.cu) * z / self.fu
        y = (v - self.cv) * z / self.fv
        pt = torch.stack([x, y, z], dim=-1)
        if not compute_jacobians:
            return pt
        zero = torch.zeros_like(u)
        jac = _rows(
            [z / self.fu, zero, (u - self.cu) / self.fu],
            [zero, z / self.fv, (v - self.cv) / self.fv],
            [zero, zero, torch.ones_like(u)],
        )
        return pt, jac

    def is_valid_measurement(self, obs):
        u, v, z = obs[..., 0], obs[..., 1], obs[..., 2]
        return (z > 0.0) & _in_image(u, v, self.w, self.h)


__all__ = ["StereoCamera", "RGBDCamera"]
