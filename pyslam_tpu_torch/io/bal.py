"""BAL (Bundle Adjustment in the Large) problem file I/O.

Copy of ``pyslam_tpu/io/bal.py`` (numpy only), with one difference: the
tokenizer of ``read_bal`` is always the native C++ parser
(``pyslam_tpu_torch.native.parse_doubles``, built with ``g++`` at first
use; a failed build raises, where the reference falls back to Python).  The
``bytes.split`` tokenizer stays beside it as its plain version
(``_parse_bal_plain``, for tests); both give the same values.

Reader/writer for the BAL text format used by benchmark configs #4/#5
(BASELINE.json:10-11).  The canonical datasets are not on disk, so
``synthetic_bal`` generates matching-statistics problems that round-trip
through the same format.

Format (https://grail.cs.washington.edu/projects/bal/):

    <num_cameras> <num_points> <num_observations>
    <camera_index> <point_index> <u> <v>        x num_observations
    <9 camera params>                           x num_cameras
        (angle-axis rotation (3), translation (3), f, k1, k2)
    <3 point coords>                            x num_points

Camera convention: P = R X + t, projected through -z (Snavely model),
matching the reprojection_bal factor kernel (graph/factor_defs.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BALData:
    """A BAL problem: poses as (C, 4, 4) world->camera SE(3) matrices,
    per-camera intrinsics (f, k1, k2), landmarks, and observations."""

    T: np.ndarray  # (C, 4, 4)
    intrinsics: np.ndarray  # (C, 3) = [f, k1, k2]
    pts: np.ndarray  # (L, 3)
    cam_idx: np.ndarray  # (M,)
    pt_idx: np.ndarray  # (M,)
    obs: np.ndarray  # (M, 2)


def _rodrigues_to_R(w):
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        k = np.where(theta > 1e-12, w / theta, 0.0)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    t = theta[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + np.sin(t) * K + (1 - np.cos(t)) * (K @ K)


def _R_to_rodrigues(R):
    from scipy.spatial.transform import Rotation

    # scipy handles the theta ~ pi branch the antisymmetric-part formula
    # degenerates on (host-side I/O code, not a device kernel).
    return Rotation.from_matrix(R).as_rotvec()


def _parse_bal_plain(raw: bytes) -> np.ndarray:
    """The plain version of ``native.parse_doubles``: ``bytes.split`` into
    numpy."""
    return np.array(raw.split(), dtype=np.float64)


def read_bal(path: str, _parse=None) -> BALData:
    """Parse a BAL problem file.  Its tokens go through the native parser
    (one ``from_chars`` pass); ``_parse`` lets a test or a timing put the
    plain tokenizer in its place."""
    from .. import native

    with open(path, "rb") as f:
        raw = f.read()
    vals = (_parse or native.parse_doubles)(raw)
    nc, np_, nm = int(vals[0]), int(vals[1]), int(vals[2])
    cur = 3
    obs_block = vals[cur : cur + 4 * nm].reshape(nm, 4)
    cur += 4 * nm
    cam_block = vals[cur : cur + 9 * nc].reshape(nc, 9)
    cur += 9 * nc
    pts = vals[cur : cur + 3 * np_].reshape(np_, 3)

    T = np.tile(np.eye(4), (nc, 1, 1))
    T[:, :3, :3] = _rodrigues_to_R(cam_block[:, :3])
    T[:, :3, 3] = cam_block[:, 3:6]
    return BALData(
        T=T,
        intrinsics=cam_block[:, 6:9].copy(),
        pts=pts.copy(),
        cam_idx=obs_block[:, 0].astype(np.int32),
        pt_idx=obs_block[:, 1].astype(np.int32),
        obs=obs_block[:, 2:4].copy(),
    )


def write_bal(path: str, data: BALData) -> None:
    """Serialize to the BAL text format."""
    lines = [f"{len(data.T)} {len(data.pts)} {len(data.obs)}"]
    for c, p, (u, v) in zip(data.cam_idx, data.pt_idx, data.obs):
        lines.append(f"{c} {p} {u:.17g} {v:.17g}")
    w = _R_to_rodrigues(data.T[:, :3, :3])
    for c in range(len(data.T)):
        params = np.concatenate([w[c], data.T[c, :3, 3], data.intrinsics[c]])
        lines.extend(f"{x:.17g}" for x in params)
    for p in data.pts:
        lines.extend(f"{x:.17g}" for x in p)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def synthetic_bal(
    n_cams=49,
    n_pts=7000,
    obs_per_pt=4,
    pixel_std=1.0,
    f=800.0,
    k1=-1e-7,
    k2=1e-13,
    seed=0,
    cam_cluster=None,
) -> BALData:
    """BAL-Ladybug-statistics synthetic problem (config #4 default shape):
    cameras on a ring looking at a central cloud, Snavely projection with
    mild radial distortion, ground-truth geometry (perturb via
    ``perturbed`` for solver inputs).

    ``cam_cluster`` places all cameras in a blob of that radius instead of
    around the ring — LOW-PARALLAX monocular geometry (the triangulation
    directions become ill-conditioned)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 2.0, (n_pts, 3))
    T = np.zeros((n_cams, 4, 4))
    for c in range(n_cams):
        ang = 2 * np.pi * c / n_cams
        if cam_cluster is not None:
            center = np.array([10.0, 0.0, 0.0]) + rng.normal(0, cam_cluster, 3)
        else:
            center = np.array([10 * np.cos(ang), 10 * np.sin(ang), rng.normal(0, 0.5)])
        # BAL cameras look down -z: optical axis -z points at the origin.
        z = center / np.linalg.norm(center)
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_wc = np.stack([x, y, z], axis=-1)
        T[c] = np.eye(4)
        T[c, :3, :3] = R_wc.T
        T[c, :3, 3] = -R_wc.T @ center

    cam_centers = np.stack([-T[c, :3, :3].T @ T[c, :3, 3] for c in range(n_cams)])
    cam_idx, pt_idx, obs = [], [], []
    for p in range(n_pts):
        d2 = np.sum((cam_centers - pts[p]) ** 2, axis=-1)
        for c in np.argsort(d2)[:obs_per_pt]:
            pc = T[c, :3, :3] @ pts[p] + T[c, :3, 3]
            if pc[2] > -0.5:  # must be in front of the -z axis
                continue
            pn = -pc[:2] / pc[2]
            r2 = pn @ pn
            uv = f * (1 + k1 * r2 + k2 * r2 * r2) * pn
            uv = uv + rng.normal(0, pixel_std, 2)
            cam_idx.append(c)
            pt_idx.append(p)
            obs.append(uv)
    intr = np.tile([f, k1, k2], (n_cams, 1))
    return BALData(
        T=T,
        intrinsics=intr,
        pts=pts,
        cam_idx=np.asarray(cam_idx, np.int32),
        pt_idx=np.asarray(pt_idx, np.int32),
        obs=np.asarray(obs),
    )


def perturbed(data: BALData, pose_noise=(0.05, 0.01), pt_noise=0.05, seed=1) -> BALData:
    """Noisy copy for solver initialization (gauge camera 0 left exact)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    T = data.T.copy()
    for c in range(1, len(T)):
        N = np.eye(4)
        N[:3, :3] = Rotation.from_rotvec(rng.normal(0, pose_noise[1], 3)).as_matrix()
        N[:3, 3] = rng.normal(0, pose_noise[0], 3)
        T[c] = N @ T[c]
    return BALData(
        T=T,
        intrinsics=data.intrinsics.copy(),
        pts=data.pts + rng.normal(0, pt_noise, data.pts.shape),
        cam_idx=data.cam_idx.copy(),
        pt_idx=data.pt_idx.copy(),
        obs=data.obs.copy(),
    )
