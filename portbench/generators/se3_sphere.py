"""A sphere2500-style SE(3) pose graph, made on the device from the seed:
poses on a golden spiral over a sphere, odometry between neighbours and
loop closures between poses close on adjacent turns, measurements with
Gaussian noise in the tangent, the odometry-integrated start.

The benchmark's own vectorized copy of the structure of
``pyslam_tpu_torch.io.synth.se3_sphere`` (the reference harness's config
3).  No loop over the poses: the loop candidates come from a band search
(the spiral's height falls with the pose index, so two poses closer than
the loop radius r lie at most r n / (2 radius) indices apart), the start is
a prefix product of the odometry by doubling, and every draw comes from
one ``torch.Generator`` on the device.

Loop closures: n - 51 of the candidates, drawn from the seed, as sphere2500
has 2,500 - 51 of them.

Sizes: ``n_poses``, ``odo_trans_std``, ``odo_rot_std``, ``radius``,
``min_loop_span`` (loop partners at least this many poses apart),
``loop_radius_factor``."""

from __future__ import annotations

import math

import torch

from .. import lie

# candidate pairs a chunk of the band search
_CHUNK = 1 << 22


def _spiral(n, radius, f64):
    k = torch.arange(n, **f64)
    theta = torch.arccos(1 - 2 * (k + 0.5) / n)  # polar angle, rising with k
    phi = math.pi * (3 - math.sqrt(5)) * k  # golden-angle azimuth
    return radius * torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                                 torch.cos(theta)], -1)


def _loop_candidates(pts, r, min_span, radius):
    """Every pair (i, j), j - i > min_span, |p_i - p_j| < r."""
    n = pts.shape[0]
    band = min(n - 1, int(math.ceil(r * n / (2 * radius))) + 1)
    if band <= min_span:
        return torch.zeros(0, 2, dtype=torch.int64, device=pts.device)
    offsets = torch.arange(min_span + 1, band + 1, device=pts.device)
    pairs = []
    rows = max(1, _CHUNK // max(len(offsets), 1))
    for s in range(0, n, rows):
        i = torch.arange(s, min(s + rows, n), device=pts.device)[:, None]
        j = i + offsets[None]
        inside = j < n
        jc = torch.where(inside, j, i)
        near = inside & ((pts[i] - pts[jc]).square().sum(-1) < r * r)
        ii, oo = near.nonzero(as_tuple=True)
        pairs.append(torch.stack([i[ii, 0], j[ii, oo]], -1))
    return torch.cat(pairs)


def _prefix_products(A):
    """P_k = A_k A_{k-1} ... A_0 for every k, by doubling."""
    P = A.clone()
    s = 1
    while s < P.shape[0]:
        nxt = P.clone()
        nxt[s:] = P[s:] @ P[:-s]
        P, s = nxt, 2 * s
    return P


def generate(sizes: dict, seed: int, device) -> dict:
    f64 = dict(dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(seed % 2**64)
    n = int(sizes["n_poses"])
    radius = float(sizes["radius"])
    n_loops = max(0, n - 51)
    trans_std, rot_std = float(sizes["odo_trans_std"]), float(sizes["odo_rot_std"])

    pts = _spiral(n, radius, f64)
    # orientation: z outward, x along the trajectory
    z = pts / torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
    idx = torch.arange(n, device=device)
    t = pts[(idx + 1).clamp(max=n - 1)] - pts[(idx - 1).clamp(min=0)]
    x = t - z * (t * z).sum(-1, keepdim=True)
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
    y = torch.linalg.cross(z, x)
    T_gt = lie.assemble(torch.stack([x, y, z], -1), pts)

    r = float(sizes["loop_radius_factor"]) * radius * 2 * math.pi / math.sqrt(n)
    cand = _loop_candidates(pts, r, int(sizes["min_loop_span"]), radius)
    if len(cand) > n_loops:
        keep = torch.randperm(len(cand), generator=gen, device=device)[:n_loops]
        cand = cand[keep.sort().values]
    edges_i = torch.cat([idx[:-1], cand[:, 0]])
    edges_j = torch.cat([idx[1:], cand[:, 1]])

    E = len(edges_i)
    xi = torch.cat([trans_std * torch.randn(E, 3, generator=gen, **f64),
                    rot_std * torch.randn(E, 3, generator=gen, **f64)], -1)
    noise = lie.assemble(lie.so3_exp(xi[:, 3:]), xi[:, :3])
    T_meas = noise @ T_gt[edges_j] @ lie.se3_inv(T_gt[edges_i])
    sqrt_info = torch.diag(torch.tensor([1 / trans_std] * 3 + [1 / rot_std] * 3, **f64)).expand(E, 6, 6)

    # the odometry-integrated start, rotations re-orthonormalized
    T_init = _prefix_products(torch.cat([T_gt[:1], T_meas[:n - 1]]))
    U, _, Vh = torch.linalg.svd(T_init[:, :3, :3])
    T_init = lie.assemble(U @ Vh, T_init[:, :3, 3])
    return dict(poses_gt=T_gt, poses_init=T_init, edges_i=edges_i, edges_j=edges_j, T_meas=T_meas,
                sqrt_info=sqrt_info.contiguous())


def counts(problem: dict) -> dict:
    n = problem["poses_init"].shape[0]
    return dict(poses=n, edges=problem["edges_i"].shape[0], odometry=n - 1,
                loops=problem["edges_i"].shape[0] - (n - 1))
