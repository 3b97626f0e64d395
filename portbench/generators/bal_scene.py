"""A bundle-adjustment problem in BAL's form (Agarwal et al., "Bundle
Adjustment in the Large", ECCV 2010), made on the device from the seed:
monocular observations of a Snavely camera (p = R X + t, pn = -p_xy / p_z,
pred = f (1 + k1 |pn|^2 + k2 |pn|^4) pn, in pixels about the image
centre), with the problem's counts of cameras, points and observations
and a skewed visibility.

The scene: cameras on a ring looking at a point cloud inside it, so that
every camera sees every point in front of it and inside a field of
|pn| <= 1.  Who sees what:

* track lengths (cameras a point), the same multiset for every seed: the
  quantiles of a power law k^-a on [2, n_cams], a set so that the lengths
  add up to ``n_obs``, the last few moved by one to make the sum exact;
  the seed deals them out to the points;
* camera popularity, the same multiset for every seed: log-normal weights
  of ``popularity_sigma``, dealt out by the seed;
* each point draws its cameras without replacement (Gumbel top-k) with
  odds of popularity x exp(``view_concentration`` cos(azimuth - the
  point's viewing azimuth)), so that a track gathers cameras from one
  side of the ring, as photographs of one facade do.

Every draw comes from one ``torch.Generator`` on the device, in a few large
calls; the host works only on the n_cams-long law of track lengths.

Sizes (the configuration's ``sizes``): ``n_cams``, ``n_pts``, ``n_obs``,
``popularity_sigma``, ``view_concentration``, ``cam_radius``,
``cloud_std``, ``cloud_radius``, ``focal`` [low, high], ``k1_std``,
``k2_std``, ``pixel_std``, ``pose_noise`` [translation, rotation],
``pt_noise``."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import lie

# score entries (points x cameras) a chunk of the camera draw
_CHUNK_ENTRIES = 1 << 26


def track_counts(n_pts: int, n_obs: int, longest: int) -> np.ndarray:
    """counts[k - 2] points of track length k, k in [2, longest], summing
    to n_pts points and n_obs observations: the quantiles (i + 1/2) / n_pts
    of the power law k^-a, a found by bisection, then the remainder
    moved by one length at the short end."""
    if not 2 * n_pts <= n_obs <= longest * n_pts:
        raise ValueError(f"{n_obs} observations of {n_pts} points cannot have tracks of 2 to {longest}")
    k = np.arange(2, longest + 1, dtype=np.float64)

    def counts(a):
        cdf = np.cumsum(k ** -a)
        cdf /= cdf[-1]
        below = np.clip(np.ceil(cdf * n_pts - 0.5), 0, n_pts).astype(np.int64)
        below[-1] = n_pts
        return np.diff(below, prepend=0)

    lo, hi = -20.0, 20.0  # totals fall as a rises
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if int(counts(mid) @ k) > n_obs:
            lo = mid
        else:
            hi = mid
    c = counts(hi)
    rest = n_obs - int(c @ k)  # 0 <= rest, and small
    for j in range(len(c) - 1):  # one length up for `rest` points, the shortest first
        step = min(rest, int(c[j]))
        c[j] -= step
        c[j + 1] += step
        rest -= step
        if rest == 0:
            break
    assert rest == 0 and int(c.sum()) == n_pts and int(c @ k) == n_obs
    return c


def _dealt(values, gen):
    """``values`` in an order drawn from the seed."""
    return values[torch.randperm(values.shape[0], generator=gen, device=values.device)]


def generate(sizes: dict, seed: int, device) -> dict:
    """Every array of one problem, float64 (indices int64), on ``device``."""
    f64 = dict(dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(seed % 2**64)
    C, N, M = int(sizes["n_cams"]), int(sizes["n_pts"]), int(sizes["n_obs"])
    radius = float(sizes["cam_radius"])

    # the scene: a cloud inside a ring of cameras looking at its centre
    pts = float(sizes["cloud_std"]) * torch.randn(N, 3, generator=gen, **f64)
    norm = torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
    pts = pts * torch.clamp(float(sizes["cloud_radius"]) / norm, max=1.0)
    azimuth = 2 * math.pi * torch.arange(C, **f64) / C
    height = 0.5 * torch.randn(C, generator=gen, **f64)
    center = torch.stack([radius * torch.cos(azimuth), radius * torch.sin(azimuth), height], -1)
    z = center / torch.linalg.vector_norm(center, dim=-1, keepdim=True)  # BAL looks down -z
    up = torch.tensor([0.0, 0.0, 1.0], **f64).expand_as(z)
    x = torch.linalg.cross(up, z)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    R = torch.stack([x, y, z], -1).transpose(-1, -2)  # world -> camera
    T_gt = lie.assemble(R, -(R @ center[..., None])[..., 0])
    f_lo, f_hi = sizes["focal"]
    intrinsics = torch.stack([
        f_lo + (f_hi - f_lo) * torch.rand(C, generator=gen, **f64),
        float(sizes["k1_std"]) * torch.randn(C, generator=gen, **f64),
        float(sizes["k2_std"]) * torch.randn(C, generator=gen, **f64),
    ], -1)

    # who sees what
    counts = torch.as_tensor(track_counts(N, M, C), device=device)
    lengths = torch.repeat_interleave(torch.arange(2, C + 1, device=device), counts)  # ascending
    owner = torch.randperm(N, generator=gen, device=device)  # the point dealt the j-th length
    q = (torch.arange(C, **f64) + 0.5) / C
    log_pop = _dealt(float(sizes["popularity_sigma"]) * torch.special.ndtri(q), gen)
    view = 2 * math.pi * torch.rand(N, generator=gen, **f64)
    kappa = float(sizes["view_concentration"])
    rows = max(1, _CHUNK_ENTRIES // C)
    cam_of, pt_of = [], []
    for s in range(0, N, rows):
        e = min(s + rows, N)
        who, need = owner[s:e], lengths[s:e]
        u = torch.rand(e - s, C, generator=gen, **f64).clamp_(1e-300, 1.0 - 1e-16)
        score = log_pop[None] + kappa * torch.cos(azimuth[None] - view[who][:, None]) - torch.log(-torch.log(u))
        top = torch.topk(score, int(need[-1]), dim=1).indices  # the lengths ascend: the last is the chunk's longest
        keep = torch.arange(top.shape[1], device=device)[None] < need[:, None]
        cam_of.append(top[keep])
        pt_of.append(who[:, None].expand_as(top)[keep])
    cam_idx, pt_idx = torch.cat(cam_of), torch.cat(pt_of)
    order = torch.sort(pt_idx, stable=True).indices  # by point, each in the order drawn
    cam_idx, pt_idx = cam_idx[order], pt_idx[order]

    p = (R[cam_idx] @ pts[pt_idx][..., None])[..., 0] + T_gt[cam_idx, :3, 3]
    pn = -p[:, :2] / p[:, 2:]
    r2 = (pn * pn).sum(-1)
    f, k1, k2 = intrinsics[cam_idx].unbind(-1)
    obs = (f * (1 + r2 * (k1 + k2 * r2)))[:, None] * pn
    obs = obs + float(sizes["pixel_std"]) * torch.randn(M, 2, generator=gen, **f64)

    trans_std, rot_std = sizes["pose_noise"]
    xi = torch.cat([trans_std * torch.randn(C, 3, generator=gen, **f64),
                    rot_std * torch.randn(C, 3, generator=gen, **f64)], -1)
    T_init = lie.assemble(lie.so3_exp(xi[:, 3:]), xi[:, :3]) @ T_gt
    T_init[0] = T_gt[0]  # the gauge anchor
    pts_init = pts + float(sizes["pt_noise"]) * torch.randn(N, 3, generator=gen, **f64)
    return dict(poses_gt=T_gt, poses_init=T_init, pts_gt=pts, pts_init=pts_init, cam_idx=cam_idx, pt_idx=pt_idx,
                obs=obs, intrinsics=intrinsics)


def counts(problem: dict) -> dict:
    return dict(cameras=problem["poses_init"].shape[0], points=problem["pts_init"].shape[0],
                observations=problem["obs"].shape[0])
