"""Dense keyframes: per-keyframe image / disparity / depth pyramids with
the precomputed 3D points of the photometric residual.

Counterpart of ``pyslam_tpu/pipelines/keyframes.py``: ``pyrdown``,
``scale_camera``, ``compute_disparity``, ``DenseKeyframe``,
``DenseStereoKeyframe`` and ``DenseRGBDKeyframe``.

A level's products are computed once, on the host, in float64 numpy
(validity and triangulation through the ``sensors`` cameras on CPU
tensors), then cast to the keyframe's dtype and copied to its device, once.
Every level has a fixed pixel count (``pixel_budget``), chosen by the same
``np.argpartition`` over the same float64 gradient magnitudes as in the
reference, so both packages track the same pixels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..sensors import RGBDCamera, StereoCamera


def pyrdown(im: np.ndarray) -> np.ndarray:
    """2x2 average-pool downsample (deterministic, matcher-independent)."""
    H, W = im.shape
    H2, W2 = H // 2, W // 2
    im = im[: 2 * H2, : 2 * W2]
    return im.reshape(H2, 2, W2, 2).mean(axis=(1, 3))


def scale_camera(camera, level: int):
    """Camera intrinsics for pyramid level ``level`` (0 = full resolution),
    with the pixel-center-preserving convention c' = (c + 0.5) * s - 0.5."""
    s = 0.5**level
    kw = dict(
        cu=(camera.cu + 0.5) * s - 0.5,
        cv=(camera.cv + 0.5) * s - 0.5,
        fu=camera.fu * s,
        fv=camera.fv * s,
        w=int(camera.w * s),
        h=int(camera.h * s),
    )
    if isinstance(camera, StereoCamera):
        return StereoCamera(b=camera.b, **kw)
    return RGBDCamera(**kw)


def compute_disparity(
    im_left: np.ndarray,
    im_right: np.ndarray,
    matcher: str = "sgbm",
    num_disparities: int | None = None,
    device=None,
):
    """Disparity map (H, W) float64 on the host; invalid pixels NaN.

    ``matcher="tpu"`` (the reference's name, kept for API parity) selects
    the port's plane-sweep block matcher (``stereo_match.block_match``),
    run on ``device`` (None: ``default_device()``). ``"sgbm"`` and ``"bm"``
    are OpenCV's matchers, imported when called, as in the reference: where
    OpenCV is not installed they raise ImportError, and no other matcher
    stands in. Inputs are float images in [0, 1] or uint8.
    ``num_disparities`` defaults to the largest multiple of 16 the image
    width supports (capped at 128)."""
    W = im_left.shape[1]
    if num_disparities is None:
        num_disparities = max(16, min(128, ((W // 3) // 16) * 16))
    if matcher == "tpu":
        from .stereo_match import block_match

        def to_f(im):
            im = np.asarray(im)
            return im.astype(np.float32) / 255.0 if im.dtype == np.uint8 else im

        dev = resolve_device(device)
        disp = block_match(
            torch.as_tensor(np.asarray(to_f(im_left), np.float32), device=dev),
            torch.as_tensor(np.asarray(to_f(im_right), np.float32), device=dev),
            num_disparities=num_disparities,
        )
        return disp.cpu().numpy().astype(np.float64)

    import cv2

    def to_u8(im):
        if im.dtype == np.uint8:
            return im
        return np.clip(im * 255.0, 0, 255).astype(np.uint8)

    l8, r8 = to_u8(im_left), to_u8(im_right)
    if matcher == "sgbm":
        m = cv2.StereoSGBM_create(
            minDisparity=0,
            numDisparities=num_disparities,
            blockSize=7,
            P1=8 * 49,
            P2=32 * 49,
            uniquenessRatio=10,
        )
    else:
        m = cv2.StereoBM_create(numDisparities=num_disparities, blockSize=15)
    disp = m.compute(l8, r8).astype(np.float64) / 16.0
    disp[disp <= 0] = np.nan
    return disp


@dataclasses.dataclass
class _Level:
    """One level's tracking data, on the keyframe's device (fixed shapes)."""

    camera: object
    im: torch.Tensor  # (H, W)
    pt_ref: torch.Tensor  # (P, 3)
    I_ref: torch.Tensor  # (P,)
    mask: torch.Tensor  # (P,) float


def _cpu64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float64))


class DenseKeyframe:
    """Shared pyramid precompute. ``depth_or_disp`` follows the camera's
    triangulate convention (disparity for stereo, depth for RGB-D).

    ``pixel_budget`` caps the residual count of a level to its
    highest-gradient pixels (DSO-style selection); every level of every
    keyframe then has the same shapes. ``pixel_budget=None`` keeps every
    pixel. The level tensors are built on ``device`` (None:
    ``default_device()``) in ``dtype``."""

    def __init__(
        self, im, depth_or_disp, camera, pyrlevels=4, min_grad=0.0, T_w=None,
        pixel_budget: int | None = 24576, dtype=torch.float32, device=None,
    ):
        self.T_w = T_w  # pose of the world in keyframe coords (set by the pipeline)
        self.pyrlevels = pyrlevels
        self.dtype = dtype
        self.device = resolve_device(device)
        self.levels: list[_Level] = []
        im = np.asarray(im, np.float64)
        dd = np.asarray(depth_or_disp, np.float64)
        for lvl in range(pyrlevels):
            cam_l = scale_camera(camera, lvl)
            if lvl > 0:
                im = pyrdown(im)
                dd = pyrdown(dd)
                if isinstance(camera, StereoCamera):
                    dd = dd / 2.0  # disparity scales with resolution
            H, W = im.shape
            vv, uu = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
            obs = np.stack([uu, vv, dd], axis=-1).reshape(-1, 3)
            finite = np.isfinite(obs[:, 2])
            obs_f = np.where(finite[:, None], obs, [0.0, 0.0, 1.0])
            valid = cam_l.is_valid_measurement(_cpu64(obs_f)).numpy() & finite
            gy, gx = np.gradient(im)
            gmag = np.sqrt(gx * gx + gy * gy).reshape(-1)
            if min_grad > 0.0:
                valid = valid & (gmag >= min_grad)
            I_flat = im.reshape(-1)
            if pixel_budget is not None and len(obs) > pixel_budget:
                # the pixel_budget highest-gradient valid pixels; invalid
                # pixels score -1, so they are chosen only when the level has
                # fewer valid pixels than the budget (and are then masked)
                score = np.where(valid, gmag, -1.0)
                sel = np.argpartition(score, len(score) - pixel_budget)[-pixel_budget:]
                obs = obs[sel]
                valid = valid[sel]
                I_flat = I_flat[sel]
            pt = cam_l.triangulate(_cpu64(np.where(valid[:, None], obs, [0.0, 0.0, 1.0]))).numpy()

            def dev(a):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(self.device)

            self.levels.append(
                _Level(camera=cam_l, im=dev(im), pt_ref=dev(pt), I_ref=dev(I_flat), mask=dev(valid.astype(np.float64)))
            )


class DenseStereoKeyframe(DenseKeyframe):
    """Stereo keyframe: disparity from ``compute_disparity`` (or injected),
    then the pyramids."""

    def __init__(self, im_left, im_right, camera, pyrlevels=4, min_grad=0.0, disp=None, matcher="sgbm",
                 pixel_budget=24576, dtype=torch.float32, device=None):
        self.im_left = np.asarray(im_left, np.float64)
        self.im_right = np.asarray(im_right, np.float64)
        if disp is None:
            disp = compute_disparity(self.im_left, self.im_right, matcher, device=device)
        super().__init__(self.im_left, disp, camera, pyrlevels, min_grad, pixel_budget=pixel_budget, dtype=dtype,
                         device=device)


class DenseRGBDKeyframe(DenseKeyframe):
    """RGB-D keyframe: the depth pyramid."""

    def __init__(self, im, depth, camera, pyrlevels=4, min_grad=0.0, pixel_budget=24576, dtype=torch.float32,
                 device=None):
        super().__init__(np.asarray(im, np.float64), depth, camera, pyrlevels, min_grad, pixel_budget=pixel_budget,
                         dtype=dtype, device=device)


__all__ = [
    "DenseKeyframe",
    "DenseStereoKeyframe",
    "DenseRGBDKeyframe",
    "compute_disparity",
    "pyrdown",
    "scale_camera",
]
