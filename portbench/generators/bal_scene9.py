"""A bundle-adjustment problem in BAL's full form, with each camera's 9
parameters estimated (rotation, translation, f, k1, k2): ``bal_scene``'s
problem at the configuration's ``sizes``, with two additions.

* **Parallax.** Bundler, the structure-from-motion pipeline that made
  BAL's problems, triangulates a track only where two of its rays are at
  least 2 degrees apart (its ``ray_angle_threshold``; Snavely et al.,
  "Photo Tourism", SIGGRAPH 2006).
  ``bal_scene``'s ring holds Final's 13,682 cameras 0.026 degrees apart and
  sees the cloud from both sides, so some tracks it draws have rays that
  are nearly parallel (neighbouring cameras) or nearly opposite (cameras
  across the ring with the point between them): a depth that no
  observation fixes, along which such a point runs off by hundreds of
  units, in float64 as in float32.  Here a track passes where the least
  eigenvalue of its triangulation's normal matrix, the sum of I - u u^T
  over its unit rays u from the true point to its cameras' centres, is at
  least 1 - cos(``min_parallax_deg``): for two rays, an angle between them
  of at least that and at most 180 degrees less that.  A track that fails
  has its last observation moved to a camera 90 degrees round the ring
  from its first (then 80, 100, 70, 60 degrees, until it passes, its
  cameras distinct), and that observation made anew from the truth with a
  fresh pixel noise.  The counts stay exact: a track keeps its length, only
  which cameras see it changes.
* **A start for the intrinsics.** Camera n's start, with u, v, w standard
  normal draws of a generator seeded from the seed:

      f (1 + ``focal_noise`` u),  k1 + ``k1_noise`` v,  k2 + ``k2_noise`` w,

  camera 0 (the gauge anchor, held whole) at its true values.  The
  observations are made from the true intrinsics (``bal_scene``)."""

from __future__ import annotations

import math

import torch

from . import bal_scene

# this generator's draws come from their own stream, apart from the scene's
_STREAM = 0x9E3779B97F4A7C15
# where a failing track's moved camera goes, round the ring from its first
_TURNS_DEG = (90.0, 80.0, 100.0, 70.0, 60.0)
# observations a chunk of the normal matrices' sums
_CHUNK = 1 << 22


def _least_eigenvalue(A):
    """The least eigenvalue of each symmetric (..., 3, 3) matrix, in closed
    form (the trigonometric solution of its characteristic cubic): the
    card's batched eigensolver refuses batches of millions."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3
    off = A[..., 0, 1] ** 2 + A[..., 0, 2] ** 2 + A[..., 1, 2] ** 2
    p = torch.sqrt(((torch.diagonal(A, dim1=-2, dim2=-1) - q[..., None]) ** 2).sum(-1) / 6 + off / 3)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = (A - q[..., None, None] * eye) / torch.where(p > 0, p, 1.0)[..., None, None]
    phi = torch.acos(torch.clamp(torch.linalg.det(B) / 2, -1.0, 1.0)) / 3
    return q + 2 * p * torch.cos(phi + 2 * math.pi / 3)


def _failing(problem: dict, cam, threshold):
    """The points whose track fails the parallax test or sees a camera
    twice (the module docstring)."""
    T, X, pt = problem["poses_gt"], problem["pts_gt"], problem["pt_idx"]
    C, L = T.shape[0], X.shape[0]
    centres = -(T[:, :3, :3].transpose(-1, -2) @ T[:, :3, 3:])[..., 0]
    N = torch.zeros(L, 3, 3, dtype=X.dtype, device=X.device)
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    for lo in range(0, cam.shape[0], _CHUNK):
        c, p = cam[lo:lo + _CHUNK], pt[lo:lo + _CHUNK]
        u = torch.nn.functional.normalize(centres[c] - X[p], dim=-1)
        N.index_add_(0, p, eye - u[:, :, None] * u[:, None, :])
    bad = _least_eigenvalue(N) < threshold
    key = torch.sort(pt * C + cam).values
    bad[torch.div(key[1:][key[1:] == key[:-1]], C, rounding_mode="floor")] = True
    return bad


def _widened(problem: dict, min_parallax_deg: float, pixel_std: float, gen) -> dict:
    """Every track made to pass the parallax test (the module docstring)."""
    cam, pt = problem["cam_idx"].clone(), problem["pt_idx"]
    C, L = problem["poses_gt"].shape[0], problem["pts_gt"].shape[0]
    threshold = 1.0 - math.cos(math.radians(min_parallax_deg))
    ends = torch.cumsum(torch.bincount(pt, minlength=L), 0)  # the observations are sorted by point
    first, last = ends - torch.bincount(pt, minlength=L), ends - 1
    moved = torch.zeros_like(cam, dtype=torch.bool)
    for turn in _TURNS_DEG:
        bad = torch.nonzero(_failing(problem, cam, threshold)).flatten()
        if bad.numel() == 0:
            break
        cam[last[bad]] = (cam[first[bad]] + round(C * turn / 360.0)) % C
        moved[last[bad]] = True
    else:
        if _failing(problem, cam, threshold).any():
            raise ValueError(f"tracks below {min_parallax_deg} degrees of parallax remain")
    if not moved.any():
        return problem
    idx = torch.nonzero(moved).flatten()
    T, K, X = problem["poses_gt"][cam[idx]], problem["intrinsics"][cam[idx]], problem["pts_gt"][pt[idx]]
    pc = (T[:, :3, :3] @ X[..., None])[..., 0] + T[:, :3, 3]
    pn = -pc[:, :2] / pc[:, 2:]
    r2 = (pn * pn).sum(-1)
    obs = problem["obs"].clone()
    obs[idx] = (K[:, 0] * (1 + r2 * (K[:, 1] + K[:, 2] * r2)))[:, None] * pn + pixel_std * torch.randn(
        idx.shape[0], 2, generator=gen, dtype=obs.dtype, device=obs.device)
    return dict(problem, cam_idx=cam, obs=obs)


def generate(sizes: dict, seed: int, device) -> dict:
    """``bal_scene.generate``'s arrays with every track's parallax made, and
    ``intrinsics_init`` (C, 3)."""
    problem = bal_scene.generate(sizes, seed, device)
    gen = torch.Generator(device=device).manual_seed((seed + _STREAM) % 2**64)
    problem = _widened(problem, float(sizes["min_parallax_deg"]), float(sizes["pixel_std"]), gen)
    true = problem["intrinsics"]
    n = torch.randn(true.shape, generator=gen, dtype=true.dtype, device=device)
    init = torch.stack([true[:, 0] * (1 + float(sizes["focal_noise"]) * n[:, 0]),
                        true[:, 1] + float(sizes["k1_noise"]) * n[:, 1],
                        true[:, 2] + float(sizes["k2_noise"]) * n[:, 2]], -1)
    init[0] = true[0]  # the gauge anchor
    return dict(problem, intrinsics_init=init)


def counts(problem: dict) -> dict:
    return bal_scene.counts(problem)
