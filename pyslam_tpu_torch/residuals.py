"""Residual library: one measurement per object.

Counterpart of ``pyslam_tpu/residuals.py``: ``QuadraticResidual``,
``PoseResidual``, ``PoseToPoseResidual``, ``PoseToPoseSwitchableResidual``,
``ReprojectionResidual``, ``LandmarkXYResidual``, ``BearingRangeResidual``,
``ReprojectionMotionOnlyBatchResidual``, ``ImuResidual`` and
``DensePriorResidual``.

Each object holds one measurement and exposes the reference's
``evaluate(params, compute_jacobians) -> (residual, jacobians)``, whose
math is the batched solver's: ``evaluate`` adds a batch axis and calls the
registered factor kernel (``graph/factor_defs.py``), so the object API and
the struct-of-arrays path cannot drift apart.

A residual keeps its measurement on the host, as numpy arrays:
``Problem._build`` stacks the measurements of a batch there and copies
each stacked array to the device once (one copy per batch and key, not
one per residual block).  ``evaluate`` copies them to the device and dtype
of the parameters it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph.core import FACTOR_KERNELS, register_factor
from .lie import se3 as _se3
from .lie.groups import Sim3, _LieGroupBase


def _host(x):
    """A measurement as a numpy array (a tensor is copied off its device)."""
    if isinstance(x, _LieGroupBase):
        x = x.mat
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _stiffness_matrix(stiffness, dim, dtype=None):
    """Normalize scalar / vector / matrix stiffness to a (dim, dim) matrix."""
    s = np.asarray(_host(stiffness), dtype=dtype)
    if s.ndim == 0:
        return s * np.eye(dim, dtype=s.dtype)
    if s.ndim == 1:
        return np.diag(s)
    return s


class _ResidualBase:
    """Shared single-measurement evaluate() via the batched kernels."""

    factor_kind: str = ""
    param_kinds: tuple = ()

    def batch_data(self) -> dict:
        """Per-factor host arrays (no batch axis) for FactorBatch stacking;
        ``camera`` is the camera object itself."""
        raise NotImplementedError

    def evaluate(self, params, compute_jacobians=None):
        """Reference signature: ``compute_jacobians`` is None (residual only)
        or a list of bools per parameter (which Jacobians to return)."""
        want = compute_jacobians is not None and any(compute_jacobians)
        vals = [torch.as_tensor(p.mat if isinstance(p, _LieGroupBase) else p)[None] for p in params]
        like = vals[0]
        data = {
            k: (v if k == "camera" else torch.as_tensor(v, dtype=like.dtype, device=like.device)[None])
            for k, v in self.batch_data().items()
        }
        r, jacs = FACTOR_KERNELS[self.factor_kind](data, *vals, compute_jacobians=want)
        r = r[0]
        if compute_jacobians is None:
            return r
        out = [(jacs[i][0] if flag else None) for i, flag in enumerate(compute_jacobians)]
        return r, out


def _pose_kind(T_obs, is_sim3):
    dim = T_obs.shape[-1]
    kind = "sim3" if is_sim3 else ("se2" if dim == 3 else "se3")
    return kind, {"se2": 3, "se3": 6, "sim3": 7}[kind]


class QuadraticResidual(_ResidualBase):
    """Curve-fit demo residual: r = stiffness * (a x^2 + b x + c - y)
    (reference QuadraticResidual, the README example)."""

    factor_kind = "quadratic"
    param_kinds = ("euclidean",)

    def __init__(self, x, y, stiffness):
        self.x = float(x)
        self.y = float(y)
        self.stiffness = float(stiffness)

    def batch_data(self):
        return {"x": self.x, "y": self.y, "stiffness": self.stiffness}


class PoseResidual(_ResidualBase):
    """Unary pose prior: r = stiffness * log(T_est * T_obs^-1)
    (reference PoseResidual).  SE2, SE3 and Sim3."""

    def __init__(self, T_obs, stiffness):
        self.T_obs = _host(T_obs)
        kind, self.dof = _pose_kind(self.T_obs, isinstance(T_obs, Sim3))
        self.factor_kind = f"prior_{kind}"
        self.param_kinds = (kind,)
        self.sqrt_info = _stiffness_matrix(stiffness, self.dof, self.T_obs.dtype)

    def batch_data(self):
        return {"T_obs": self.T_obs, "sqrt_info": self.sqrt_info}


class PoseToPoseResidual(_ResidualBase):
    """Binary odometry / loop-closure factor:
    r = stiffness * log(T_2_0 * T_1_0^-1 * T_2_1_obs^-1)
    (reference PoseToPoseResidual).  SE2, SE3 and Sim3."""

    def __init__(self, T_2_1_obs, stiffness):
        self.T_obs = _host(T_2_1_obs)
        kind, self.dof = _pose_kind(self.T_obs, isinstance(T_2_1_obs, Sim3))
        self.factor_kind = f"between_{kind}"
        self.param_kinds = (kind, kind)
        self.sqrt_info = _stiffness_matrix(stiffness, self.dof, self.T_obs.dtype)

    def batch_data(self):
        return {"T_obs": self.T_obs, "sqrt_info": self.sqrt_info}


class PoseToPoseSwitchableResidual(_ResidualBase):
    """Vertigo switchable loop closure (Suenderhauf & Protzel, ICRA 2012):
    parameters [T_1, T_2, s], ``s`` a (1,) euclidean switch the caller
    initializes near 1.0; near 0 after the solve means the edge was
    rejected.

    r = [s * stiffness * log(T_2_0 T_1_0^-1 T_obs^-1); xi * (1 - s)].
    The batched-graph equivalent is ``build.switchable_pose_graph``."""

    def __init__(self, T_2_1_obs, stiffness, xi: float = 5.0):
        self.T_obs = _host(T_2_1_obs)
        kind, self.dof = _pose_kind(self.T_obs, False)
        self.factor_kind = f"between_{kind}_switch"
        self.param_kinds = (kind, kind, "euclidean")
        self.sqrt_info = _stiffness_matrix(stiffness, self.dof, self.T_obs.dtype)
        self.xi = float(xi)

    def batch_data(self):
        return {"T_obs": self.T_obs, "sqrt_info": self.sqrt_info, "xi": np.asarray(self.xi, self.T_obs.dtype)}


class ReprojectionResidual(_ResidualBase):
    """Stereo/RGB-D reprojection: r = stiffness * (cam.project(T * p) - obs)
    (reference ReprojectionResidual).  Parameters: [T_cam_w (SE3), pt_w (3,)]."""

    factor_kind = "reprojection"
    param_kinds = ("se3", "euclidean")

    def __init__(self, camera, obs, stiffness):
        self.camera = camera
        self.obs = _host(obs)
        self.sqrt_info = _stiffness_matrix(stiffness, 3, self.obs.dtype)

    def batch_data(self):
        return {"camera": self.camera, "obs": self.obs, "sqrt_info": self.sqrt_info}


class LandmarkXYResidual(_ResidualBase):
    """2D relative-position landmark observation (g2o EDGE_SE2_XY):
    r = stiffness * (act(T, l) - obs), the landmark in the observing pose's
    frame.  Parameters: [T (SE2), l (2,)]."""

    factor_kind = "landmark_xy_se2"
    param_kinds = ("se2", "euclidean")

    def __init__(self, obs, stiffness):
        self.obs = _host(obs)
        self.sqrt_info = _stiffness_matrix(stiffness, 2, self.obs.dtype)

    def batch_data(self):
        return {"obs": self.obs, "sqrt_info": self.sqrt_info}


class BearingRangeResidual(_ResidualBase):
    """2D bearing-range landmark observation: with p = act(T, l),
    r = stiffness * [wrap(atan2(p_y, p_x) - bearing_obs), |p| - range_obs].
    Parameters: [T (SE2), l (2,)].  ``obs`` is [bearing, range]."""

    factor_kind = "bearing_range_se2"
    param_kinds = ("se2", "euclidean")

    def __init__(self, obs, stiffness):
        self.obs = _host(obs)
        self.sqrt_info = _stiffness_matrix(stiffness, 2, self.obs.dtype)

    def batch_data(self):
        return {"obs": self.obs, "sqrt_info": self.sqrt_info}


class ReprojectionMotionOnlyBatchResidual(_ResidualBase):
    """Motion-only BA: N fixed landmarks, one camera pose to optimize
    (reference ReprojectionMotionOnlyBatchResidual).  Parameters: [T_cam_w].

    The N landmarks are folded into the residual's own data, so one
    residual block covers the whole point set (residual dim 3N)."""

    factor_kind = "reprojection_motion_only_flat"
    param_kinds = ("se3",)

    def __init__(self, camera, obs, pts_w, stiffness):
        self.camera = camera
        self.obs = _host(obs)  # (N, 3)
        self.pts_w = _host(pts_w)  # (N, 3)
        self.stiffness = _host(stiffness)

    def batch_data(self):
        n = self.obs.shape[0]
        s = _stiffness_matrix(self.stiffness, 3, self.obs.dtype)
        return {"camera": self.camera, "obs": self.obs, "pt_w": self.pts_w, "sqrt_info": np.broadcast_to(s, (n, 3, 3))}


@register_factor("reprojection_motion_only_flat")
def _reproj_motion_only_flat(data, T, compute_jacobians=True):
    """The motion-only kernel with the point set as one residual of 3N
    rows: data (F, N, ...), T (F, 4, 4)."""
    cam = data["camera"]
    obs, pts, sqrt_info = data["obs"], data["pt_w"], data["sqrt_info"]
    F, N = obs.shape[0], obs.shape[1]
    pt_cam = _se3.act(T[:, None], pts)
    if not compute_jacobians:
        r = (sqrt_info @ (cam.project(pt_cam) - obs)[..., None])[..., 0]
        return r.reshape(F, 3 * N), None
    pred, cam_jac = cam.project(pt_cam, compute_jacobians=True)
    r = (sqrt_info @ (pred - obs)[..., None])[..., 0]
    J = sqrt_info @ cam_jac @ _se3.odot(pt_cam)
    return r.reshape(F, 3 * N), (J.reshape(F, 3 * N, 6),)


class ImuResidual(_ResidualBase):
    """Preintegrated inertial factor (``imu.py``, Forster's on-manifold
    preintegration).  Parameters: [T_i (SE3, T_b_w), T_j (SE3), v_i (3,),
    v_j (3,), b_i (6,)].

    ``pim`` is a ``PreintegratedImu`` from ``imu.preintegrate``; the sqrt
    information defaults to the inverse Cholesky factor of its covariance."""

    factor_kind = "imu_preintegrated"
    param_kinds = ("se3", "se3", "euclidean", "euclidean", "euclidean")

    _PIM_KEYS = ("dR", "dv", "dp", "J_Rg", "J_vg", "J_va", "J_pg", "J_pa", "b_lin", "dt")

    def __init__(self, pim, gravity=(0.0, 0.0, -9.81), sqrt_info=None):
        from .imu import sqrt_info_of

        self.pim = pim
        self.sqrt_info = _host(sqrt_info if sqrt_info is not None else sqrt_info_of(pim))
        self.gravity = np.asarray(gravity, self.sqrt_info.dtype)
        self._data = {k: _host(getattr(pim, k)) for k in self._PIM_KEYS}

    def batch_data(self):
        return {**self._data, "sqrt_info": self.sqrt_info, "gravity": self.gravity}


class DensePriorResidual(_ResidualBase):
    """The dense Gaussian prior that marginalization produces
    (``graph/marginalize.py``): r = A @ eta(x) - c over the Markov blanket
    of the removed variables, eta the per-slot left tangent from the
    frozen linearization points.  Made by ``Problem.marginalize_parameters``
    (the kernel name is the registered blanket signature)."""

    def __init__(self, factor_kind, param_kinds, data):
        self.factor_kind = factor_kind
        self.param_kinds = tuple(param_kinds)
        self._data = {k: _host(v) for k, v in data.items()}

    def batch_data(self):
        return self._data


__all__ = [
    "QuadraticResidual",
    "PoseResidual",
    "PoseToPoseResidual",
    "PoseToPoseSwitchableResidual",
    "ReprojectionResidual",
    "LandmarkXYResidual",
    "BearingRangeResidual",
    "ReprojectionMotionOnlyBatchResidual",
    "ImuResidual",
    "DensePriorResidual",
]
