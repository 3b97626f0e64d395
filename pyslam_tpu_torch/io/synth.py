"""Synthetic dataset generators with benchmark-equivalent statistics.

The canonical datasets (Intel/M3500, sphere2500, BAL) are not on disk and
there is no network access (SURVEY.md §4.5, §7 hard part #5), so these
generators synthesize graphs with matching structure for the five benchmark
configs (BASELINE.json:7-11):

  * ``se2_loop``      — small 2D pose ring with loop closures     (config #1)
  * ``se2_manhattan`` — M3500-style 2D grid walk                  (config #2)
  * ``se3_sphere``    — sphere2500-style 3D pose graph            (config #3)
  * ``ba_synthetic``  — BAL-style bundle-adjustment problem       (configs #4/#5)

All generators are numpy-based (host-side data prep, device-side solving) and
return ground truth + noisy initialization + the measurement set, from which
``build_*_graph`` assemble FactorGraphs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _rot2(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def _se2_mat(x, y, theta):
    T = np.eye(3)
    T[:2, :2] = _rot2(theta)
    T[:2, 2] = (x, y)
    return T


def _se2_noise(rng, trans_std, rot_std):
    """Sample a small SE(2) displacement (as a matrix) for measurement noise."""
    return _se2_mat(
        rng.normal(0, trans_std), rng.normal(0, trans_std), rng.normal(0, rot_std)
    )


@dataclasses.dataclass
class PoseGraphData:
    """A pose-graph problem: ground truth, noisy init, edge list."""

    dim: int  # 2 or 3
    T_gt: np.ndarray  # (N, d+1, d+1) ground-truth poses
    T_init: np.ndarray  # (N, d+1, d+1) noisy initialization
    edges_i: np.ndarray  # (E,)
    edges_j: np.ndarray  # (E,)
    T_meas: np.ndarray  # (E, d+1, d+1) measured relative poses T_j_i
    sqrt_info: np.ndarray  # (E, dof, dof)


def with_outliers(data: "PoseGraphData", n_outliers: int, magnitude: float = 2.0,
                  seed: int = 0):
    """Append ``n_outliers`` WRONG loop-closure edges to a pose graph —
    random pose pairs with random large relative measurements (tangent
    noise of std ``magnitude``), each reusing an existing edge's
    sqrt_info.  The standard robustness benchmark (Vertigo/GNC papers);
    feed the result to ``build.switchable_pose_graph`` or
    ``solver.solve_gnc``.  Returns (poisoned_data, outlier_mask) with the
    mask True on the appended edges.

    The torch port has SE(3) only so far: a 2D graph raises
    NotImplementedError until SE(2) is ported."""
    import dataclasses

    import torch

    from ..lie import se3 as _se3

    if data.dim == 2:
        raise NotImplementedError("with_outliers on SE(2) graphs: SE(2) is not ported yet")
    rng = np.random.default_rng(seed)
    n = data.T_gt.shape[0]
    dof = data.sqrt_info.shape[-1]
    bad_i = rng.integers(0, n, n_outliers)
    bad_j = (bad_i + rng.integers(n // 4, max(n // 2, n // 4 + 1), n_outliers)) % n
    bad_T = _se3.exp(
        torch.from_numpy(rng.normal(size=(n_outliers, dof)) * magnitude)
    ).numpy()
    si_pick = rng.integers(0, len(data.sqrt_info), n_outliers)
    poisoned = dataclasses.replace(
        data,
        edges_i=np.concatenate([np.asarray(data.edges_i), bad_i.astype(np.asarray(data.edges_i).dtype)]),
        edges_j=np.concatenate([np.asarray(data.edges_j), bad_j.astype(np.asarray(data.edges_j).dtype)]),
        T_meas=np.concatenate([np.asarray(data.T_meas), bad_T]),
        sqrt_info=np.concatenate([np.asarray(data.sqrt_info), np.asarray(data.sqrt_info)[si_pick]]),
    )
    mask = np.zeros(len(poisoned.edges_i), bool)
    mask[len(data.edges_i):] = True
    return poisoned, mask


def se2_loop(n_poses=100, n_loops=12, odo_trans_std=0.03, odo_rot_std=0.01, seed=0):
    """Config #1: ~100-pose SE(2) ring with odometry + loop closures."""
    rng = np.random.default_rng(seed)
    # ground truth: a circle
    radius = n_poses / (2 * np.pi)
    T_gt = np.stack(
        [
            _se2_mat(
                radius * np.cos(2 * np.pi * k / n_poses),
                radius * np.sin(2 * np.pi * k / n_poses),
                2 * np.pi * k / n_poses + np.pi / 2,
            )
            for k in range(n_poses)
        ]
    )
    return _finish_se2(rng, T_gt, n_loops, odo_trans_std, odo_rot_std, loop_span=(2, n_poses - 1))


def se2_manhattan(n_poses=3500, step=1.0, odo_trans_std=0.05, odo_rot_std=0.02, seed=0):
    """Config #2: M3500-style Manhattan-world random walk with proximity
    loop closures (matching the published dataset's statistics: grid motion,
    ~2.2k loop edges at distance <= 1 cell)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n_poses)) + 1
    pos = np.zeros(2)
    heading = 0.0
    poses = [np.eye(3)]
    for _ in range(n_poses - 1):
        if rng.random() < 0.25:  # turn at intersections
            heading += rng.choice([-1, 1]) * np.pi / 2
        nxt = pos + step * np.array([np.cos(heading), np.sin(heading)])
        if np.any(np.abs(nxt) > side / 2):  # bounce off the arena walls
            heading += np.pi / 2
            nxt = pos + step * np.array([np.cos(heading), np.sin(heading)])
        pos = nxt
        poses.append(_se2_mat(pos[0], pos[1], heading))
    T_gt = np.stack(poses)
    # proximity loop closures
    n_loops = max(1, n_poses // 2)
    return _finish_se2(
        rng, T_gt, n_loops, odo_trans_std, odo_rot_std, loop_span=(10, None), proximity=1.5
    )


def _finish_se2(rng, T_gt, n_loops, trans_std, rot_std, loop_span, proximity=None):
    n = len(T_gt)
    edges_i = list(range(n - 1))
    edges_j = list(range(1, n))
    # loop closures
    added = set()
    tries = 0
    while len(added) < n_loops and tries < n_loops * 50:
        tries += 1
        i = int(rng.integers(0, n - 1))
        lo, hi = loop_span
        hi = hi or n - 1
        j = int(rng.integers(min(i + lo, n - 1), n))
        if proximity is not None:
            if np.linalg.norm(T_gt[i][:2, 2] - T_gt[j][:2, 2]) > proximity:
                continue
            if j - i < lo:
                continue
        if (i, j) in added or i == j:
            continue
        added.add((i, j))
    for i, j in sorted(added):
        edges_i.append(i)
        edges_j.append(j)
    edges_i = np.asarray(edges_i)
    edges_j = np.asarray(edges_j)

    # measurement convention: T_meas = noise @ T_j_w @ inv(T_i_w), matching
    # the between-factor estimate T_est = T_j @ inv(T_i)
    T_meas = np.stack(
        [
            _se2_noise(rng, trans_std, rot_std) @ T_gt[j] @ np.linalg.inv(T_gt[i])
            for i, j in zip(edges_i, edges_j)
        ]
    )
    dof = 3
    info = np.zeros((len(edges_i), dof, dof))
    info[:] = np.diag([1.0 / trans_std, 1.0 / trans_std, 1.0 / rot_std])

    # noisy init: integrate odometry only
    T_init = [T_gt[0]]
    for k in range(n - 1):
        T_init.append(T_meas[k] @ T_init[-1])
    return PoseGraphData(2, T_gt, np.stack(T_init), edges_i, edges_j, T_meas, info)


@dataclasses.dataclass
class LandmarkSLAM2DData:
    """A 2D landmark-SLAM problem (Victoria-Park model family): SE(2)
    trajectory with odometry edges + point landmarks observed as
    bearing-range or relative-position measurements.

    Poses follow the kernel library's world-to-body convention
    (graph/factor_defs.py): the body-frame landmark is act(T, l)."""

    T_gt: np.ndarray  # (N, 3, 3) ground-truth world-to-body poses
    T_init: np.ndarray  # (N, 3, 3) odometry-integrated init
    lm_gt: np.ndarray  # (L, 2) ground-truth landmark positions (world)
    lm_init: np.ndarray  # (L, 2) first-observation triangulated init
    edges_i: np.ndarray  # (E,) odometry/loop between-factor slot 1
    edges_j: np.ndarray  # (E,)
    T_meas: np.ndarray  # (E, 3, 3) measured T_j @ inv(T_i)
    sqrt_info: np.ndarray  # (E, 3, 3)
    obs_pose: np.ndarray  # (M,) observing pose index
    obs_lm: np.ndarray  # (M,) observed landmark index
    obs: np.ndarray  # (M, 2) [bearing, range] or [x_local, y_local]
    obs_sqrt_info: np.ndarray  # (M, 2, 2)
    obs_type: str  # 'bearing_range' | 'xy'


def landmark_slam_2d(
    n_poses=200,
    n_landmarks=60,
    max_range=8.0,
    obs_type="bearing_range",
    odo_trans_std=0.03,
    odo_rot_std=0.01,
    bearing_std=0.01,
    range_std=0.05,
    xy_std=0.05,
    seed=0,
):
    """Simulate a 2D landmark-SLAM run: a circular trajectory through a
    field of landmarks, odometry between consecutive poses (no loop-closure
    edges — loop closure emerges from re-observing landmarks), and a
    bearing-range or relative-position measurement for every landmark
    within ``max_range`` of a pose.  Landmarks are initialized from their
    FIRST observation back-projected through the odometry-integrated pose
    (the honest online-SLAM init)."""
    rng = np.random.default_rng(seed)
    radius = max(4.0, n_poses * 0.25 / (2 * np.pi) * 4)
    # body-to-world trajectory on a circle, heading tangent
    W = np.stack(
        [
            _se2_mat(
                radius * np.cos(2 * np.pi * k / n_poses),
                radius * np.sin(2 * np.pi * k / n_poses),
                2 * np.pi * k / n_poses + np.pi / 2,
            )
            for k in range(n_poses)
        ]
    )
    T_gt = np.stack([np.linalg.inv(Wk) for Wk in W])  # world-to-body

    # landmarks in an annulus straddling the trajectory ring, within sensor
    # reach (±0.8 max_range) so every landmark is observed from several poses
    ang = rng.uniform(0, 2 * np.pi, n_landmarks)
    half = 0.8 * max_range
    rad = rng.uniform(max(0.0, radius - half), radius + half, n_landmarks)
    lm_gt = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)

    # odometry chain
    edges_i = np.arange(n_poses - 1)
    edges_j = np.arange(1, n_poses)
    T_meas = np.stack(
        [
            _se2_noise(rng, odo_trans_std, odo_rot_std)
            @ T_gt[j]
            @ np.linalg.inv(T_gt[i])
            for i, j in zip(edges_i, edges_j)
        ]
    )
    sqrt_info = np.zeros((n_poses - 1, 3, 3))
    sqrt_info[:] = np.diag([1.0 / odo_trans_std, 1.0 / odo_trans_std, 1.0 / odo_rot_std])
    T_init = [T_gt[0]]
    for k in range(n_poses - 1):
        T_init.append(T_meas[k] @ T_init[-1])
    T_init = np.stack(T_init)

    # observations: all landmarks within max_range of each pose
    obs_pose, obs_lm, obs_list = [], [], []
    for k in range(n_poses):
        p_local = (T_gt[k, :2, :2] @ lm_gt.T).T + T_gt[k, :2, 2]
        rho = np.linalg.norm(p_local, axis=1)
        for li in np.flatnonzero(rho <= max_range):
            obs_pose.append(k)
            obs_lm.append(li)
            if obs_type == "bearing_range":
                b = np.arctan2(p_local[li, 1], p_local[li, 0])
                obs_list.append(
                    [b + rng.normal(0, bearing_std), rho[li] + rng.normal(0, range_std)]
                )
            else:
                obs_list.append(list(p_local[li] + rng.normal(0, xy_std, 2)))
    obs_pose = np.asarray(obs_pose, np.int64)
    obs_lm = np.asarray(obs_lm, np.int64)
    obs = np.asarray(obs_list)
    if obs_type == "bearing_range":
        # keep bearings wrapped the way a sensor reports them
        obs[:, 0] = np.arctan2(np.sin(obs[:, 0]), np.cos(obs[:, 0]))
        osi = np.zeros((len(obs), 2, 2))
        osi[:] = np.diag([1.0 / bearing_std, 1.0 / range_std])
    else:
        osi = np.zeros((len(obs), 2, 2))
        osi[:] = np.eye(2) / xy_std

    # landmark init: back-project the first observation through T_init
    lm_init = np.zeros_like(lm_gt)
    seen = np.zeros(n_landmarks, bool)
    for m in range(len(obs)):
        li = obs_lm[m]
        if seen[li]:
            continue
        seen[li] = True
        if obs_type == "bearing_range":
            b, r = obs[m]
            p_local = np.array([r * np.cos(b), r * np.sin(b)])
        else:
            p_local = obs[m]
        Tk = T_init[obs_pose[m]]
        lm_init[li] = Tk[:2, :2].T @ (p_local - Tk[:2, 2])
    # drop never-observed landmarks
    keep = np.flatnonzero(seen)
    remap = -np.ones(n_landmarks, np.int64)
    remap[keep] = np.arange(len(keep))
    return LandmarkSLAM2DData(
        T_gt=T_gt,
        T_init=T_init,
        lm_gt=lm_gt[keep],
        lm_init=lm_init[keep],
        edges_i=edges_i,
        edges_j=edges_j,
        T_meas=T_meas,
        sqrt_info=sqrt_info,
        obs_pose=obs_pose,
        obs_lm=remap[obs_lm],
        obs=obs,
        obs_sqrt_info=osi,
        obs_type=obs_type,
    )


def _so3_noise(rng, std):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.normal(0, std, 3)).as_matrix()


def _se3_noise(rng, trans_std, rot_std):
    T = np.eye(4)
    T[:3, :3] = _so3_noise(rng, rot_std)
    T[:3, 3] = rng.normal(0, trans_std, 3)
    return T


def se3_sphere(n_poses=2500, n_loops=None, odo_trans_std=0.02, odo_rot_std=0.01, seed=0):
    """Config #3: sphere2500-style SE(3) pose graph — a spiral trajectory on
    a sphere with odometry plus latitude-adjacent loop closures (the
    published sphere2500 has 2500 poses / 4949 constraints; default loop
    count reproduces that edge density)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    if n_loops is None:
        # sphere2500: 4949 edges = (n-1) odo + 2450 loops
        n_loops = max(0, n_poses - 51)
    radius = 10.0
    # spiral from pole to pole
    k = np.arange(n_poses)
    theta = np.arccos(1 - 2 * (k + 0.5) / n_poses)  # polar angle
    golden = np.pi * (3 - np.sqrt(5))
    phi = golden * k  # azimuth
    pts = radius * np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], axis=-1
    )
    # orientation: z-axis outward, x-axis along the trajectory
    T_gt = np.zeros((n_poses, 4, 4))
    for i in range(n_poses):
        z = pts[i] / np.linalg.norm(pts[i])
        t = pts[min(i + 1, n_poses - 1)] - pts[max(i - 1, 0)]
        x = t - z * (t @ z)
        x /= np.linalg.norm(x) + 1e-12
        y = np.cross(z, x)
        T_gt[i] = np.eye(4)
        T_gt[i][:3, :3] = np.stack([x, y, z], axis=-1)
        T_gt[i][:3, 3] = pts[i]

    edges_i = list(range(n_poses - 1))
    edges_j = list(range(1, n_poses))
    # loop closures between spatially-near poses on adjacent spiral rings
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    pairs = tree.query_pairs(r=radius * 2 * np.pi / np.sqrt(n_poses) * 0.9, output_type="ndarray")
    pairs = pairs[np.abs(pairs[:, 0] - pairs[:, 1]) > 10]
    if len(pairs) > n_loops:
        sel = rng.choice(len(pairs), n_loops, replace=False)
        pairs = pairs[sel]
    for i, j in pairs:
        edges_i.append(min(i, j))
        edges_j.append(max(i, j))
    edges_i = np.asarray(edges_i)
    edges_j = np.asarray(edges_j)

    T_meas = np.stack(
        [
            _se3_noise(rng, odo_trans_std, odo_rot_std) @ T_gt[j] @ np.linalg.inv(T_gt[i])
            for i, j in zip(edges_i, edges_j)
        ]
    )
    info = np.zeros((len(edges_i), 6, 6))
    info[:] = np.diag([1.0 / odo_trans_std] * 3 + [1.0 / odo_rot_std] * 3)

    T_init = [T_gt[0]]
    for k in range(n_poses - 1):
        T_init.append(T_meas[k] @ T_init[-1])
    # re-orthonormalize drifted rotations
    T_init = np.stack(T_init)
    u, _, vt = np.linalg.svd(T_init[:, :3, :3])
    T_init[:, :3, :3] = u @ vt
    return PoseGraphData(3, T_gt, T_init, edges_i, edges_j, T_meas, info)


@dataclasses.dataclass
class BAData:
    """A BAL-style bundle-adjustment problem."""

    T_gt: np.ndarray  # (C, 4, 4) camera poses (world -> camera)
    T_init: np.ndarray
    pts_gt: np.ndarray  # (L, 3)
    pts_init: np.ndarray
    cam_idx: np.ndarray  # (M,)
    pt_idx: np.ndarray  # (M,)
    obs: np.ndarray  # (M, 3) stereo observations [u, v, d]
    camera: dict  # intrinsics for sensors.StereoCamera


def ba_synthetic(
    n_cams=49,
    n_pts=7000,
    obs_per_pt=4,
    pixel_std=0.5,
    pose_noise=(0.05, 0.01),
    pt_noise=0.05,
    seed=0,
    cam_radius=10.0,
    cam_cluster=None,
):
    """Configs #4/#5: BAL-Ladybug-style BA — cameras on a ring looking at a
    central point cloud, stereo observations with pixel noise.

    ``cam_cluster`` (a small float) clusters ALL cameras in a blob of that
    radius at distance ``cam_radius`` instead of spreading them on the ring:
    baselines ~cluster with depths ~cam_radius gives LOW-PARALLAX geometry
    (parallax angle ~ cluster/radius) — the ill-conditioned-Jl regime the
    square-root Schur path (solver/schur_sqrt.py) targets."""
    rng = np.random.default_rng(seed)
    cam = dict(cu=320.0, cv=240.0, fu=500.0, fv=500.0, b=0.3, w=640, h=480)

    # point cloud in a central blob
    pts = rng.normal(0, 2.0, (n_pts, 3))
    # cameras on a ring of radius cam_radius looking inward (or clustered)
    T_gt = np.zeros((n_cams, 4, 4))
    for c in range(n_cams):
        ang = 2 * np.pi * c / n_cams
        if cam_cluster is not None:
            center = np.array([cam_radius, 0.0, 0.0]) + rng.normal(0, cam_cluster, 3)
        else:
            center = np.array(
                [cam_radius * np.cos(ang), cam_radius * np.sin(ang), rng.normal(0, 0.5)]
            )
        z = -center / np.linalg.norm(center)  # optical axis toward origin
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_wc = np.stack([x, y, z], axis=-1)  # camera axes in world coords
        T = np.eye(4)
        T[:3, :3] = R_wc.T  # world -> camera
        T[:3, 3] = -R_wc.T @ center
        T_gt[c] = T

    # observations: each point seen by its obs_per_pt nearest cameras
    # (vectorized in point chunks — Venice-scale problems have ~1M points)
    cam_centers = np.stack([-T_gt[c, :3, :3].T @ T_gt[c, :3, 3] for c in range(n_cams)])
    fu, fv, cu, cv, b = cam["fu"], cam["fv"], cam["cu"], cam["cv"], cam["b"]
    R = T_gt[:, :3, :3]
    t = T_gt[:, :3, 3]
    cam_parts, pt_parts, obs_parts = [], [], []
    chunk = 65536
    kk = min(obs_per_pt, n_cams)
    cc2 = np.sum(cam_centers**2, axis=-1)
    for s in range(0, n_pts, chunk):
        P = pts[s : s + chunk]
        # |p-c|^2 = |p|^2 + |c|^2 - 2 p.c via BLAS (no (n, C, 3) temporary)
        d2 = np.sum(P**2, axis=-1)[:, None] + cc2[None] - 2.0 * (P @ cam_centers.T)
        sel = np.argpartition(d2, kk - 1, axis=1)[:, :kk]  # (n, k)
        n = len(P)
        pc = np.einsum("nkij,nj->nki", R[sel], P) + t[sel]
        z = pc[..., 2]
        u = fu * pc[..., 0] / z + cu + rng.normal(0, pixel_std, z.shape)
        v = fv * pc[..., 1] / z + cv + rng.normal(0, pixel_std, z.shape)
        d = fu * b / z + rng.normal(0, pixel_std, z.shape)
        ok = (z >= 0.5) & (u >= 0) & (u < cam["w"]) & (v >= 0) & (v < cam["h"]) & (d > 0)
        ni, ki = np.nonzero(ok)
        cam_parts.append(sel[ni, ki])
        pt_parts.append(s + ni)
        obs_parts.append(np.stack([u[ni, ki], v[ni, ki], d[ni, ki]], axis=-1))
    cam_idx = np.concatenate(cam_parts)
    pt_idx = np.concatenate(pt_parts)
    obs = np.concatenate(obs_parts)

    T_init = np.stack([_se3_noise(rng, *pose_noise) @ T_gt[c] for c in range(n_cams)])
    T_init[0] = T_gt[0]  # gauge anchor
    pts_init = pts + rng.normal(0, pt_noise, pts.shape)
    return BAData(
        T_gt,
        T_init,
        pts,
        pts_init,
        np.asarray(cam_idx),
        np.asarray(pt_idx),
        np.asarray(obs),
        cam,
    )


def _sim3_inv(S):
    """Numpy Sim(3) inverse [[sR, t], [0, 1]]^-1 (f64 host math)."""
    sR, t = S[:3, :3], S[:3, 3]
    s2 = float(sR[0] @ sR[0])
    out = np.eye(4)
    out[:3, :3] = sR.T / s2
    out[:3, 3] = -(sR.T / s2) @ t
    return out


def _sim3_noise(rng, trans_std, rot_std, scale_std, scale_bias=0.0):
    """Random Sim(3) group element near identity: [[e^d * R_n, t_n], [0, 1]].
    ``scale_bias`` injects systematic per-edge scale drift (monocular VO)."""
    S = np.eye(4)
    d = scale_bias + (rng.normal(0, scale_std) if scale_std > 0 else 0.0)
    S[:3, :3] = np.exp(d) * _so3_noise(rng, rot_std)
    S[:3, 3] = rng.normal(0, trans_std, 3)
    return S


def sim3_loop(
    n_poses=120,
    n_loops=6,
    odo_trans_std=0.02,
    odo_rot_std=0.01,
    odo_scale_std=0.005,
    scale_drift=0.0,
    gt_scale_std=0.0,
    seed=0,
):
    """Sim(3) pose graph: circular monocular trajectory with per-edge scale
    drift and drift-free loop closures (the Strasdat RSS 2010 scenario —
    beyond-reference; the reference's liegroups dep stops at SE(3)).

    ``scale_drift`` is the systematic log-scale error per odometry edge: the
    integrated init's scale is off by e^{scale_drift * n} at the loop end,
    and only the Sim(3) loop closures can pull it back.  ``gt_scale_std``
    gives ground-truth poses themselves random scales (for pure recovery
    tests).  Returns PoseGraphData with dim=3 whose matrices are Sim(3);
    build.sim3_pose_graph consumes it.
    """
    rng = np.random.default_rng(seed)
    radius = 8.0
    ang = 2 * np.pi * np.arange(n_poses) / n_poses
    S_gt = np.zeros((n_poses, 4, 4))
    for i in range(n_poses):
        c, s = np.cos(ang[i]), np.sin(ang[i])
        R = np.array([[-s, 0.0, c], [c, 0.0, s], [0.0, 1.0, 0.0]]).T  # heading along tangent
        sc = np.exp(rng.normal(0, gt_scale_std)) if gt_scale_std > 0 else 1.0
        S_gt[i] = np.eye(4)
        S_gt[i][:3, :3] = sc * R
        S_gt[i][:3, 3] = radius * np.array([c, s, 0.0])

    edges_i = list(range(n_poses - 1))
    edges_j = list(range(1, n_poses))
    span = n_poses // (n_loops + 1)
    for k in range(n_loops):
        i = k * span
        j = min(i + n_poses // 2, n_poses - 1)  # diametrically-opposed closure
        edges_i.append(i)
        edges_j.append(j)
    # the loop-closing edge back to the start (the scale-drift corrector)
    edges_i.append(n_poses - 1)
    edges_j.append(0)
    edges_i = np.asarray(edges_i)
    edges_j = np.asarray(edges_j)

    n_odo = n_poses - 1
    S_meas = np.stack(
        [
            _sim3_noise(
                rng,
                odo_trans_std,
                odo_rot_std,
                odo_scale_std,
                scale_bias=(scale_drift if e < n_odo else 0.0),
            )
            @ S_gt[j]
            @ _sim3_inv(S_gt[i])
            for e, (i, j) in enumerate(zip(edges_i, edges_j))
        ]
    )
    info = np.zeros((len(edges_i), 7, 7))
    info[:] = np.diag(
        [1.0 / odo_trans_std] * 3
        + [1.0 / odo_rot_std] * 3
        + [1.0 / max(odo_scale_std, 1e-3)]
    )

    S_init = [S_gt[0]]
    for k in range(n_odo):
        S_init.append(S_meas[k] @ S_init[-1])
    return PoseGraphData(3, S_gt, np.stack(S_init), edges_i, edges_j, S_meas, info)


@dataclasses.dataclass
class ImuData:
    """A visual-inertial trajectory: keyframe ground truth + the raw IMU
    samples between consecutive keyframes (for pyslam_tpu.imu)."""

    T_gt: np.ndarray  # (N, 4, 4) keyframe poses, T_b_w (world -> body)
    v_gt: np.ndarray  # (N, 3) world-frame velocities
    b_gyro: np.ndarray  # (3,) true (constant) gyro bias
    b_accel: np.ndarray  # (3,) true accel bias
    omega: np.ndarray  # (N-1, K, 3) body angular rate samples per interval
    accel: np.ndarray  # (N-1, K, 3) body specific-force samples
    dts: np.ndarray  # (N-1, K) sample intervals
    gravity: np.ndarray  # (3,)


def imu_circle(
    n_keyframes=6,
    kf_dt=0.5,
    imu_rate=200.0,
    radius=5.0,
    omega_z=0.4,
    gyro_noise=0.0,
    accel_noise=0.0,
    b_gyro=(0.0, 0.0, 0.0),
    b_accel=(0.0, 0.0, 0.0),
    seed=0,
):
    """Constant-rate circular trajectory with analytically exact IMU
    signals: p(t) = r[cos wt, sin wt, 0], yaw tracking the motion, so the
    body rate is constant [0, 0, w] and the specific force is constant in
    the body frame — integration error isolates the preintegrator's
    discretization, not the generator's.

    Measured samples include the given constant biases and white noise.
    Poses are returned in the solver's T_b_w convention.
    """
    rng = np.random.default_rng(seed)
    g = np.array([0.0, 0.0, -9.81])
    b_g = np.asarray(b_gyro, float)
    b_a = np.asarray(b_accel, float)
    K = max(1, int(round(kf_dt * imu_rate)))
    dt = kf_dt / K

    def state(t):
        th = omega_z * t
        c, s = np.cos(th), np.sin(th)
        p = radius * np.array([c, s, 0.0])
        v = radius * omega_z * np.array([-s, c, 0.0])
        a_w = -radius * omega_z**2 * np.array([c, s, 0.0])
        R_wb = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])  # yaw = th
        return p, v, a_w, R_wb

    N = n_keyframes
    T_gt = np.zeros((N, 4, 4))
    v_gt = np.zeros((N, 3))
    omega = np.zeros((N - 1, K, 3))
    accel = np.zeros((N - 1, K, 3))
    dts = np.full((N - 1, K), dt)
    for i in range(N):
        p, v, _, R_wb = state(i * kf_dt)
        T_gt[i] = np.eye(4)
        T_gt[i][:3, :3] = R_wb.T  # T_b_w
        T_gt[i][:3, 3] = -R_wb.T @ p
        v_gt[i] = v
    for i in range(N - 1):
        for k in range(K):
            t = i * kf_dt + (k + 0.5) * dt  # midpoint sampling
            _, _, a_w, R_wb = state(t)
            omega[i, k] = np.array([0.0, 0.0, omega_z]) + b_g
            accel[i, k] = R_wb.T @ (a_w - g) + b_a
            if gyro_noise > 0:
                omega[i, k] += rng.normal(0, gyro_noise, 3)
            if accel_noise > 0:
                accel[i, k] += rng.normal(0, accel_noise, 3)
    return ImuData(T_gt, v_gt, b_g, b_a, omega, accel, dts, g)
