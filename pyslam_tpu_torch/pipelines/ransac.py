"""Frame-to-frame sparse stereo RANSAC.

Counterpart of ``pyslam_tpu/pipelines/ransac.py``: ``kabsch`` and
``FrameToFrameRANSAC``. The hypothesize-and-test loop is one batched
pass: M minimal samples drawn up front, M rigid transforms by batched
Kabsch (``torch.linalg.svd`` of M 3x3 matrices), the M x N reprojection
errors at once, the hypothesis with the most inliers, an all-inlier
weighted refit, and optionally a motion-only Gauss-Newton polish in pixel
space.

Drawing the samples (``draw_samples``, from a ``torch.Generator`` seeded
with ``seed``) is apart from scoring them (``ransac_from_samples``):
``jax.random`` and a ``torch.Generator`` draw different samples, and the
reference's samples given to ``ransac_from_samples`` give the reference's
hypothesis.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..graph.core import FactorBatch, FactorGraph, VariableBlock
from ..lie.groups import SE3
from ..losses import L2Loss
from ..solver import lm


def kabsch(P, Q, w=None):
    """Rigid T with Q ~ R P + t (least squares, batched over leading dims).

    P, Q: (..., N, 3); w: optional (..., N) weights. Returns (..., 4, 4)."""
    P = torch.as_tensor(P)
    Q = torch.as_tensor(Q)
    if w is None:
        w = torch.ones(P.shape[:-1], dtype=P.dtype, device=P.device)
    wsum = torch.sum(w, dim=-1, keepdim=True)
    cp = torch.sum(w[..., None] * P, dim=-2) / wsum
    cq = torch.sum(w[..., None] * Q, dim=-2) / wsum
    Pc = P - cp[..., None, :]
    Qc = Q - cq[..., None, :]
    H = torch.einsum("...n,...ni,...nj->...ij", w, Pc, Qc)
    U, _, Vt = torch.linalg.svd(H)
    # right-handed correction: R = V diag(1, 1, det(V U^T)) U^T
    det = torch.linalg.det(U @ Vt)
    D = torch.cat([torch.ones(H.shape[:-2] + (2,), dtype=H.dtype, device=H.device), det[..., None]], dim=-1)
    R = torch.einsum("...ji,...j,...kj->...ik", Vt, D, U)
    t = cq - torch.einsum("...ij,...j->...i", R, cp)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.eye(4, dtype=H.dtype, device=H.device)[3:].expand(H.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def draw_samples(n_points: int, num_iters: int, generator: torch.Generator):
    """(num_iters, 3) index triples into n_points, on the generator's device
    (a collision is harmless: a degenerate sample's hypothesis loses the
    vote)."""
    return torch.randint(0, n_points, (num_iters, 3), generator=generator, device=generator.device)


def _inlier_mask(camera, obs_1, obs_2, T, thresh):
    P1 = camera.triangulate(obs_1)
    P1r = (T[:3, :3] * P1[:, None, :]).sum(-1) + T[:3, 3]
    err = torch.linalg.norm(camera.project(P1r) - obs_2, dim=-1)
    return (err < thresh) & camera.is_valid_measurement(obs_2) & (P1r[..., 2] > 0)


def ransac_from_samples(camera, obs_1, obs_2, samples, thresh):
    """Score the hypotheses of ``samples`` (M, 3) against every
    correspondence and refit on the best one's inliers: (T_best (4, 4),
    inlier mask (N,), the best hypothesis's inlier count)."""
    P1 = camera.triangulate(obs_1)  # (N, 3) frame-1 points
    P2 = camera.triangulate(obs_2)
    T = kabsch(P1[samples], P2[samples])  # (M, 4, 4)
    # every hypothesis against every correspondence in one pass
    P1h = (T[:, None, :3, :3] * P1[None, :, None, :]).sum(-1) + T[:, None, :3, 3]
    pred = camera.project(P1h)  # (M, N, 3)
    err = torch.linalg.norm(pred - obs_2[None], dim=-1)
    valid = camera.is_valid_measurement(obs_2)[None] & (P1h[..., 2] > 0)
    inlier = (err < thresh) & valid
    counts = torch.sum(inlier, dim=-1)
    best = torch.argmax(counts)
    # refit on the best hypothesis's inliers (weighted Kabsch)
    T_best = kabsch(P1, P2, w=inlier[best].to(P1.dtype))
    return T_best, _inlier_mask(camera, obs_1, obs_2, T_best, thresh), counts[best]


def _polish_motion_only(camera, obs_1, obs_2, T0, mask):
    """Motion-only reprojection Gauss-Newton (LM 10) over the inliers."""
    N = obs_1.shape[0]
    P1 = camera.triangulate(obs_1)
    dev, dt = obs_1.device, obs_1.dtype
    batch = FactorBatch(
        "reprojection_motion_only", ("pose",), (torch.zeros(N, dtype=torch.int64, device=dev),),
        {"camera": camera, "obs": obs_2, "pt_w": P1,
         "sqrt_info": torch.eye(3, dtype=dt, device=dev).expand(N, 3, 3)},
        L2Loss(), mask.to(dt),
    )
    g = FactorGraph({"pose": VariableBlock.create("se3", T0[None])}, [batch])
    solved, _ = lm.solve(g, lm.Options(method="lm", max_iters=10))
    return solved.blocks["pose"].values[0]


class FrameToFrameRANSAC:
    """Sparse stereo frame-to-frame motion estimation with RANSAC.

    Usage (the reference's API):
        ransac = FrameToFrameRANSAC(camera)
        T_21, inlier_mask = ransac.compute_transform(obs_1, obs_2)

    obs_1 / obs_2: (N, 3) matched stereo observations [uL, vL, d] in frames
    1 and 2, computed in their dtype on ``device`` (None:
    ``default_device()``). Returns the SE3 estimate T_2_1 (frame-1 points
    into frame 2) and the boolean inlier mask (numpy). The samples come
    from a ``torch.Generator`` seeded with ``seed`` at every call."""

    def __init__(self, camera, num_iters: int = 256, inlier_thresh: float = 2.0, seed: int = 0,
                 polish: bool = True, device=None):
        self.camera = camera
        self.num_iters = num_iters
        self.inlier_thresh = inlier_thresh
        self.seed = seed
        self.polish = polish
        self.device = resolve_device(device)

    def compute_transform(self, obs_1, obs_2, samples=None):
        """``samples`` (M, 3) replaces the draw (``draw_samples``)."""
        obs_1 = torch.as_tensor(obs_1).to(self.device)
        obs_2 = torch.as_tensor(obs_2).to(self.device)
        if samples is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            samples = draw_samples(obs_1.shape[0], self.num_iters, gen)
        else:
            samples = torch.as_tensor(samples, dtype=torch.int64).to(self.device)
        T, mask, _ = ransac_from_samples(self.camera, obs_1, obs_2, samples, self.inlier_thresh)
        if self.polish:
            # pixel-space refinement: motion-only reprojection GN on the
            # inliers (the Kabsch fit is 3D-3D and ignores the
            # depth-dependent triangulation noise), then the inliers again
            # under the refined estimate
            T = _polish_motion_only(self.camera, obs_1, obs_2, T, mask)
            mask = _inlier_mask(self.camera, obs_1, obs_2, T, self.inlier_thresh)
        return SE3(T), mask.cpu().numpy()


__all__ = ["FrameToFrameRANSAC", "kabsch", "draw_samples", "ransac_from_samples"]
