"""Dense direct visual-odometry pipelines: keyframe-based coarse-to-fine
photometric tracking with a Student-t robust loss and a motion model.

Counterpart of ``pyslam_tpu/pipelines/dense.py``: ``DenseStereoPipeline``,
``DenseRGBDPipeline``, ``PrefetchedFrame``, ``track``, ``prefetch``,
``track_batch`` and the stepwise per-level variant.

The reference traces the whole pyramid into one XLA program. Here a frame
is a loop over the levels, coarse to fine, each a ``lm.solve`` of a
single-pose graph with one photometric factor over the level's pixels:

  * the pose stays on the device from level to level and is read once, at
    the end of the frame;
  * the Student-t scale of a level is estimated at the level's initial
    pose and frozen for its solve (Kerl-style IRLS) as a device scalar, so
    it costs no host read;
  * the single-pose graph is built around the same index tensor at every
    level and frame, so ``lm.solve`` finds its dense-assembly plan in the
    plan cache (``assemble.cached_dense_plan``) after the first solve;
  * the frame's pyramid is built on the device from one upload; a uint8
    frame is uploaded raw and normalized there (``* (1/255)``), while a
    keyframe's images are normalized on the host (``/ 255.0``), as in the
    reference.

``track_batch`` solves K frames against the current keyframe level by
level with ``solver.solve_batched``: every frame keeps its own LM state
and stop code (a finished frame is frozen, as under the reference's
vmap), and its own frozen scale (``batched._ScalePerProblem`` with a scale a
frame).

Every pipeline builds on ``device`` (None: ``default_device()``, the CUDA
card; ``"cpu"`` asks for the CPU) in ``dtype`` (float32, the reference's).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..graph.core import FACTOR_KERNELS, FactorBatch, FactorGraph, VariableBlock
from ..lie.groups import SE3
from ..losses import TDistributionLoss
from ..solver import lm
from ..solver.batched import _ScalePerProblem, solve_batched
from ..utils import pack_corners
from .keyframes import DenseKeyframe, DenseRGBDKeyframe, DenseStereoKeyframe


def _as_mat(T) -> np.ndarray:
    if isinstance(T, SE3):
        T = T.mat
    if torch.is_tensor(T):
        return T.detach().cpu().numpy()
    return np.asarray(T)


def _device_pyramid(im, levels: int):
    """2x2 average-pool pyramid (``keyframes.pyrdown``) of a (..., H, W)
    frame or stack of frames, on its device. uint8 input is normalized to
    [0, 1] float32 there first."""
    if im.dtype == torch.uint8:
        im = im.to(torch.float32) * (1.0 / 255.0)
    ims = [im]
    for _ in range(1, levels):
        x = ims[-1]
        H2, W2 = x.shape[-2] // 2, x.shape[-1] // 2
        x = x[..., : 2 * H2, : 2 * W2].reshape(tuple(x.shape[:-2]) + (H2, 2, W2, 2))
        ims.append(x.mean(dim=(-3, -1)))
    return ims


def _estimate_tdist_scale(data, T, nu, kind="photometric_se3"):
    """Fixed-point Student-t scale (F,) of each factor's residuals at the
    poses T (F, 4, 4): a mean over the masked pixels, ten iterations from
    the masked mean square (unlike ``TDistributionLoss._estimate_scale``,
    which averages over every residual)."""
    r, _ = FACTOR_KERNELS[kind](data, T, compute_jacobians=False)
    m = data["mask"]
    n = torch.clamp(torch.sum(m, dim=-1), min=1.0)
    sigma2 = torch.sum(m * r * r, dim=-1) / n + 1e-12
    for _ in range(10):
        w = (nu + 1.0) / (nu + r * r / sigma2[:, None])
        sigma2 = torch.sum(m * w * r * r, dim=-1) / n + 1e-12
    return torch.sqrt(sigma2)


class _DensePipelineBase:
    """Shared tracking machinery (the reference's
    ``_compute_frame_to_keyframe_pose``)."""

    def __init__(
        self,
        camera,
        first_pose=np.eye(4),
        pyrlevels: int = 4,
        keyframe_trans_thresh: float = 3.0,
        keyframe_rot_thresh: float = 0.3,
        loss=None,
        stiffness: float = 1.0 / 0.25,
        min_grad: float = 0.0,
        max_iters_per_level: int = 15,
        depth_stiffness: float | None = None,
        pixel_budget: int | None = 24576,
        affine_illumination: bool = False,
        dtype=torch.float32,
        device=None,
    ):
        self.camera = camera
        self.pyrlevels = pyrlevels
        self.keyframe_trans_thresh = keyframe_trans_thresh
        self.keyframe_rot_thresh = keyframe_rot_thresh
        self.loss = loss if loss is not None else TDistributionLoss(nu=5.0)
        self.stiffness = stiffness
        self.min_grad = min_grad
        self.pixel_budget = pixel_budget
        self.dtype = dtype
        self.device = resolve_device(device)
        # DSO-style brightness transfer: per-frame gain / bias eliminated by
        # variable projection inside the kernel (photometric.py)
        self._kind = "photometric_affine_se3" if affine_illumination else "photometric_se3"
        # tight per-level stopping: photometric alignment needs the tail
        # iterations (the cost decrease per step shrinks fast near the optimum)
        self.options = lm.Options(method="lm", max_iters=max_iters_per_level, min_cost_decrease=0.9999,
                                  min_update_norm=1e-8)
        self.keyframes: list[DenseKeyframe] = []
        self.T_c_w: list[np.ndarray] = []  # camera-from-world per tracked frame
        self._first_pose = _as_mat(first_pose)
        self._T_last_rel = np.eye(4)  # motion model: the last frame-to-frame motion
        # built on the device once: a host-to-device copy synchronizes
        self._stiff = torch.full((1,), stiffness, dtype=dtype, device=self.device)
        self._index = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._weight = torch.ones(1, dtype=dtype, device=self.device)
        self._free = torch.zeros(1, dtype=torch.bool, device=self.device)

    # ---- the per-level solve ----

    def prefetch(self, im) -> "PrefetchedFrame":
        """Start the upload of a future tracked frame while the current
        frame's solve runs: a copy of the frame in pinned host memory and a
        ``non_blocking`` copy to the device, queued on the current stream,
        so every later use on that stream comes after it. Pass the handle
        to ``track`` in place of the image."""
        host = _track_input(im, self.dtype)
        src = torch.from_numpy(host)
        if self.device.type == "cuda":
            # the caching host allocator keeps the pinned buffer until the
            # copy has run, however early the handle is dropped
            src = src.pin_memory()
        return PrefetchedFrame(host=host, dev=src.to(self.device, non_blocking=True))

    def _track_pyramid(self, im_track) -> list:
        if not torch.is_tensor(im_track):
            im_track = torch.from_numpy(np.ascontiguousarray(im_track)).to(self.device)
        if im_track.dtype != torch.uint8:
            im_track = im_track.to(self.dtype)
        return _device_pyramid(im_track, self.pyrlevels)

    def _nu(self):
        """The Student-t nu whose scale is estimated per level, or None
        (the loss is used as it is)."""
        if isinstance(self.loss, TDistributionLoss) and self.loss.scale is None:
            return self.loss.nu
        return None

    def _level_data(self, level, im, K=None):
        """The factor data of one level against the tracking image(s) ``im``
        ((H, W), or (K, H, W) with ``K``)."""
        ims = im[None] if K is None else im
        im4 = pack_corners(im)[None] if K is None else torch.func.vmap(pack_corners)(im)
        F = 1 if K is None else K
        return {
            "camera": level.camera,
            "pt_ref": level.pt_ref[None].expand(F, -1, -1),
            "I_ref": level.I_ref[None].expand(F, -1),
            "mask": level.mask[None].expand(F, -1),
            "im_track": ims,
            # corner-packed once a level, outside the LM loop: a kernel
            # evaluation then gathers one row a pixel instead of four
            "im_track4": im4,
            "stiffness": self._stiff.expand(F),
        }

    def _graph(self, T, data, loss):
        batch = FactorBatch(self._kind, ("pose",), (self._index,), data, loss, self._weight)
        return FactorGraph({"pose": VariableBlock("se3", T[None], self._free)}, [batch])

    def _solve(self, graph):
        solved, _ = lm.solve(graph, self.options)
        return solved.blocks["pose"].values[0]

    def _level_loss(self, data, T_init):
        """Freeze the Student-t scale for a level (Kerl-style IRLS): a loss
        whose scale is re-estimated inside every cost call is scale
        invariant, so LM would see no decrease from a uniformly shrinking
        residual. The scale is estimated once, at the level's initial pose,
        and stays a device scalar."""
        nu = self._nu()
        if nu is None:
            return self.loss
        return TDistributionLoss(nu=nu, scale=_estimate_tdist_scale(data, T_init[None], nu, self._kind)[0])

    def _track_levels(self, keyframe, pyr, T):
        """Coarse-to-fine tracking of one frame: T (4, 4) on the device in,
        T_track_key on the device out."""
        for lvl in range(len(keyframe.levels) - 1, -1, -1):
            data = self._level_data(keyframe.levels[lvl], pyr[lvl])
            T = self._solve(self._graph(T, data, self._level_loss(data, T)))
        return T

    def _solve_level(self, level_data, im_track_l, T_init: np.ndarray) -> np.ndarray:
        """One level's solve from a host pose to a host pose (the stepwise
        variant's step)."""
        T = torch.as_tensor(np.asarray(T_init), dtype=self.dtype).to(self.device)
        data = self._level_data(level_data, im_track_l)
        return self._solve(self._graph(T, data, self._level_loss(data, T))).cpu().numpy()

    def _compute_frame_to_keyframe_pose(self, keyframe: DenseKeyframe, im_track, guess: np.ndarray) -> np.ndarray:
        """Coarse-to-fine photometric alignment: T_track_key, read to the
        host once."""
        pyr = self._track_pyramid(im_track)
        T = torch.as_tensor(np.asarray(guess), dtype=self.dtype).to(self.device)
        return self._track_levels(keyframe, pyr, T).cpu().numpy()

    def _compute_frame_to_keyframe_pose_stepwise(self, keyframe: DenseKeyframe, im_track,
                                                 guess: np.ndarray) -> np.ndarray:
        """Per-level host loop (kept for debugging / level inspection)."""
        pyr = self._track_pyramid(im_track)
        T = guess.copy()
        for lvl in range(self.pyrlevels - 1, -1, -1):
            T = self._solve_level(keyframe.levels[lvl], pyr[lvl], T)
        return T

    def track_batch(self, ims, guesses=None):
        """Offline throughput mode: K frames solved against the CURRENT
        keyframe together. The frames are uploaded as one (K, H, W) stack
        and each level's K solves run as one ``solve_batched``.

        ``ims``: K same-shape intensity frames (list or (K, H, W) array).
        ``guesses``: optional (K, 4, 4) frame-from-keyframe initial guesses;
        by default the motion model extrapolated from the last tracked
        frame (guess_k = T_rel^(k+1) · T_last_w · T_key_w^-1). Returns the
        K SE3 world poses and appends them to ``self.T_c_w``. No keyframe
        decision is made inside a batch."""
        if not self.keyframes:
            raise RuntimeError(
                "track_batch needs an existing keyframe: track() the first "
                "frame (with its depth/right image) before batching"
            )
        ims = [_track_input(im, self.dtype) for im in ims]
        K = len(ims)
        kf = self.keyframes[-1]
        T_key_w_inv = np.linalg.inv(kf.T_w)
        if guesses is None:
            g = []
            T_w = self.T_c_w[-1]
            for _ in range(K):
                T_w = self._T_last_rel @ T_w
                g.append(T_w @ T_key_w_inv)
            guesses = np.stack(g)
        else:
            guesses = np.stack([_as_mat(gk) for gk in guesses])

        pyr_b = self._track_pyramid(np.stack(ims))
        T = torch.as_tensor(guesses, dtype=self.dtype).to(self.device)
        nu = self._nu()
        for lvl in range(len(kf.levels) - 1, -1, -1):
            data = self._level_data(kf.levels[lvl], pyr_b[lvl], K)
            loss = self.loss if nu is None else _ScalePerProblem(
                TDistributionLoss(nu=nu), K, _estimate_tdist_scale(data, T, nu, self._kind))
            graphs = [self._graph(T[k], {key: (v[k: k + 1] if torch.is_tensor(v) else v)
                                         for key, v in data.items()}, loss) for k in range(K)]
            values, _ = solve_batched(graphs, self.options)
            T = values["pose"][:, 0]
        T_rel = T.cpu().numpy()
        out = []
        for k in range(K):
            T_w = T_rel[k] @ kf.T_w
            prev = self.T_c_w[-1]
            self._T_last_rel = T_w @ np.linalg.inv(prev)
            self.T_c_w.append(T_w)
            out.append(SE3(T_w))
        return out

    # ---- bookkeeping shared by both frontends ----

    def _track_common(self, make_keyframe, im_track, guess):
        if not self.keyframes:
            kf = make_keyframe()
            kf.T_w = self._first_pose
            self.keyframes.append(kf)
            self.T_c_w.append(self._first_pose.copy())
            return SE3(self.T_c_w[-1])

        kf = self.keyframes[-1]
        T_key_w = kf.T_w
        if guess is None:
            # motion model: propagate the last frame-to-frame motion
            T_track_w_guess = self._T_last_rel @ self.T_c_w[-1]
            guess_rel = T_track_w_guess @ np.linalg.inv(T_key_w)
        else:
            guess_rel = _as_mat(guess)
        T_track_key = self._compute_frame_to_keyframe_pose(kf, im_track, guess_rel)
        T_track_w = T_track_key @ T_key_w

        prev = self.T_c_w[-1]
        self._T_last_rel = T_track_w @ np.linalg.inv(prev)
        self.T_c_w.append(T_track_w)

        # keyframe decision (the reference's thresholds), numpy on one 4x4
        trans = np.linalg.norm(T_track_key[:3, 3])
        cos_theta = np.clip((np.trace(T_track_key[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rot = abs(float(np.arccos(cos_theta)))
        if trans > self.keyframe_trans_thresh or rot > self.keyframe_rot_thresh:
            new_kf = make_keyframe()
            new_kf.T_w = T_track_w
            self.keyframes.append(new_kf)
        return SE3(T_track_w)


def _host_float01(im):
    """Keyframe-side normalization (host, once a keyframe): uint8 camera
    frames -> [0, 1] float32; float frames pass through."""
    im = np.asarray(im)
    if im.dtype == np.uint8:
        return im.astype(np.float32) / 255.0
    return im


def _track_input(im, dtype=torch.float32):
    """Tracked-frame input: uint8 stays raw (the device pyramid normalizes
    it after a 4x smaller upload); floats become ``dtype`` on the host."""
    im = np.asarray(im)
    if im.dtype == np.uint8:
        return im
    return im.astype(torch.empty((), dtype=dtype).numpy().dtype, copy=False)


class PrefetchedFrame:
    """Handle from ``pipeline.prefetch(im)``: the device copy of a future
    tracked frame, started early so that it overlaps the current frame's
    solve, and the host copy, which keyframe creation needs."""

    __slots__ = ("host", "dev")

    def __init__(self, host, dev):
        self.host = host
        self.dev = dev


class DenseStereoPipeline(_DensePipelineBase):
    """Dense stereo direct VO.

    ``track(im_left, im_right, guess=None, disp=None)`` returns the SE3
    camera-from-world estimate of the frame and appends it to
    ``self.T_c_w``. ``disp`` injects a precomputed disparity map; otherwise
    ``matcher`` selects the disparity stage: OpenCV's "sgbm" / "bm" on the
    host, or "tpu" (the reference's name) for the port's plane-sweep block
    matcher on the pipeline's device (``stereo_match.py``)."""

    def __init__(self, *args, matcher: str = "sgbm", **kw):
        super().__init__(*args, **kw)
        self.matcher = matcher

    def track(self, im_left, im_right, guess=None, disp=None):
        if isinstance(im_left, PrefetchedFrame):
            host_left, track_in = im_left.host, im_left.dev
        else:
            host_left, track_in = im_left, _track_input(im_left, self.dtype)

        def make_keyframe():
            return DenseStereoKeyframe(
                _host_float01(host_left), _host_float01(im_right), self.camera, self.pyrlevels, self.min_grad,
                disp=disp, matcher=self.matcher, pixel_budget=self.pixel_budget, dtype=self.dtype,
                device=self.device,
            )

        return self._track_common(make_keyframe, track_in, guess)


class DenseRGBDPipeline(_DensePipelineBase):
    """Dense RGB-D direct VO: ``track(im, depth, guess=None)``."""

    def track(self, im, depth, guess=None):
        if isinstance(im, PrefetchedFrame):
            host_im, track_in = im.host, im.dev
        else:
            host_im, track_in = im, _track_input(im, self.dtype)

        def make_keyframe():
            return DenseRGBDKeyframe(
                _host_float01(host_im), depth, self.camera, self.pyrlevels, self.min_grad,
                pixel_budget=self.pixel_budget, dtype=self.dtype, device=self.device,
            )

        return self._track_common(make_keyframe, track_in, guess)


__all__ = ["DenseStereoPipeline", "DenseRGBDPipeline", "PrefetchedFrame"]
