"""Batched residual + analytic-Jacobian kernels, one per factor kind.

Counterpart of ``pyslam_tpu/graph/factor_defs.py``.  Ported so far: the
pose priors and the relative-pose factors of SE(2), SE(3) and Sim(3), all
through the group-generic ``_prior`` / ``_between``; the stereo / RGB-D
reprojection factors; the BAL (Snavely) reprojection factors with fixed
and with optimized intrinsics and the pose prior of a BAL camera; and the
pose-to-landmark factors of 2D and 3D landmark SLAM; the switchable
loop closures of SE(2) and SE(3); and the two chordal-relaxation kinds of
``graph/initialize.py``; and the ``quadratic`` curve fit of the
reference's README (``residuals.QuadraticResidual``).  ``sqrt_info`` may
carry the factor axis, (F, m, m), or be one (m, m) matrix for the whole
batch.  A point at depth z <= 0 gives inf / NaN as in the reference; the
LM loop rejects such a step.  Conventions are the reference's:
  * residuals are pre-multiplied by ``sqrt_info``,
  * Jacobians are w.r.t. *left* perturbations exp(eps) * T,
  * the pose-to-pose measurement is T_2_1, with estimate
    T_2_1_est = T_2_0 * T_1_0^-1.

Every kernel returns ``(r, jacs)`` with r (F, m) and jacs a tuple of
(F, m, dof_slot) tensors (or ``(r, None)`` when Jacobians are skipped).
"""

from __future__ import annotations

import math

import torch

from ..lie import se2, se3, sim3
from .core import register_factor


def _bmv(A, v):
    return (A @ v[..., None])[..., 0]


# --------------------------------------------------------------------------
# Pose priors: r = sqrt_info * log(T_est * T_obs^-1)
# --------------------------------------------------------------------------


def _prior(ops, data, T, compute_jacobians):
    r_local = ops.log(T @ ops.inv(data["T_obs"]))
    r = _bmv(data["sqrt_info"], r_local)
    if not compute_jacobians:
        return r, None
    J = data["sqrt_info"] @ ops.inv_left_jacobian(r_local)
    return r, (J,)


@register_factor("prior_se3")
def prior_se3(data, T, compute_jacobians=True):
    """Unary SE(3) prior (reference PoseResidual)."""
    return _prior(se3, data, T, compute_jacobians)


@register_factor("prior_se2")
def prior_se2(data, T, compute_jacobians=True):
    """Unary SE(2) prior (reference PoseResidual)."""
    return _prior(se2, data, T, compute_jacobians)


@register_factor("prior_sim3")
def prior_sim3(data, S, compute_jacobians=True):
    """Unary Sim(3) prior: PoseResidual's shape with a 7-dof tangent."""
    return _prior(sim3, data, S, compute_jacobians)


# --------------------------------------------------------------------------
# Pose-to-pose (odometry / loop closure):
#   r = sqrt_info * log(T_2_0 * T_1_0^-1 * T_obs^-1)
# --------------------------------------------------------------------------


def _between(ops, data, T1, T2, compute_jacobians):
    T_est = T2 @ ops.inv(T1)
    r_local = ops.log(T_est @ ops.inv(data["T_obs"]))
    r = _bmv(data["sqrt_info"], r_local)
    if not compute_jacobians:
        return r, None
    J2 = data["sqrt_info"] @ ops.inv_left_jacobian(r_local)
    # a left perturbation of T1 enters as exp(-Ad(T_est) eps): hence the
    # -Adjoint factor
    J1 = -(J2 @ ops.adjoint(T_est))
    return r, (J1, J2)


@register_factor("between_se3")
def between_se3(data, T1, T2, compute_jacobians=True):
    """SE(3) relative-pose factor (reference PoseToPoseResidual)."""
    return _between(se3, data, T1, T2, compute_jacobians)


@register_factor("between_se2")
def between_se2(data, T1, T2, compute_jacobians=True):
    """SE(2) relative-pose factor (reference PoseToPoseResidual)."""
    return _between(se2, data, T1, T2, compute_jacobians)


# --------------------------------------------------------------------------
# Switchable loop closures (Suenderhauf & Protzel ICRA 2012, "Vertigo"):
#   r = [ s * sqrt_info * log(T_est * T_obs^-1) ;  xi * (1 - s) ]
# Each loop closure carries a scalar switch s (init 1); an outlier edge is
# cheaper to switch off (paying the xi prior) than to satisfy.  The switch
# enters linearly and unclamped, so the residual is smooth everywhere.
# --------------------------------------------------------------------------


def _between_switch(ops, data, T1, T2, s, compute_jacobians):
    r_b, jac = _between(ops, data, T1, T2, compute_jacobians)
    sv = s[:, 0:1]  # (F, 1)
    xi = data["xi"]
    xi = xi[:, None] if xi.ndim == 1 else xi  # (F, 1)
    r = torch.cat([sv * r_b, xi * (1.0 - sv)], dim=1)
    if not compute_jacobians:
        return r, None
    J1, J2 = jac
    zrow = J1.new_zeros((J1.shape[0], 1, J1.shape[2]))
    J1s = torch.cat([sv[:, :, None] * J1, zrow], dim=1)
    J2s = torch.cat([sv[:, :, None] * J2, zrow], dim=1)
    Js = torch.cat([r_b[:, :, None], -xi[:, :, None]], dim=1)  # (F, m + 1, 1)
    return r, (J1s, J2s, Js)


@register_factor("between_se2_switch")
def between_se2_switch(data, T1, T2, s, compute_jacobians=True):
    """Switchable SE(2) loop-closure factor (slots: pose_i, pose_j, switch)."""
    return _between_switch(se2, data, T1, T2, s, compute_jacobians)


@register_factor("between_se3_switch")
def between_se3_switch(data, T1, T2, s, compute_jacobians=True):
    """Switchable SE(3) loop-closure factor (slots: pose_i, pose_j, switch)."""
    return _between_switch(se3, data, T1, T2, s, compute_jacobians)


@register_factor("between_sim3")
def between_sim3(data, S1, S2, compute_jacobians=True):
    """Sim(3) relative-similarity factor: the scale-drift-aware loop
    closure of monocular SLAM.  The 7th residual component is the log scale
    ratio."""
    return _between(sim3, data, S1, S2, compute_jacobians)


# --------------------------------------------------------------------------
# Reprojection: r = sqrt_info * (camera.project(T_cam_w * pt_w) - obs)
# --------------------------------------------------------------------------


def _reprojection(data, T, pt, compute_jacobians):
    """(r, sqrt_info @ d pred / d p_cam or None, p_cam) of a ``sensors``
    camera, shared by both reprojection kernels."""
    cam = data["camera"]
    pt_cam = se3.act(T, pt)
    if not compute_jacobians:
        return _bmv(data["sqrt_info"], cam.project(pt_cam) - data["obs"]), None, pt_cam
    pred, cam_jac = cam.project(pt_cam, compute_jacobians=True)
    r = _bmv(data["sqrt_info"], pred - data["obs"])
    return r, data["sqrt_info"] @ cam_jac, pt_cam


@register_factor("reprojection")
def reprojection(data, T, pt, compute_jacobians=True):
    """Stereo/RGB-D reprojection factor (reference ReprojectionResidual).
    ``data['camera']`` is a ``sensors`` camera; observations are (F, 3)."""
    r, S_cam, pt_cam = _reprojection(data, T, pt, compute_jacobians)
    if not compute_jacobians:
        return r, None
    return r, (S_cam @ se3.odot(pt_cam), S_cam @ T[..., :3, :3])


@register_factor("reprojection_motion_only")
def reprojection_motion_only(data, T, compute_jacobians=True):
    """Motion-only batched reprojection: landmarks fixed in ``data['pt_w']``
    (reference ReprojectionMotionOnlyBatchResidual)."""
    r, S_cam, pt_cam = _reprojection(data, T, data["pt_w"], compute_jacobians)
    if not compute_jacobians:
        return r, None
    return r, (S_cam @ se3.odot(pt_cam),)


# --------------------------------------------------------------------------
# BAL monocular reprojection (Snavely camera model):
#   p_cam = T * X;  pn = -p_cam[:2] / p_cam[2]           (BAL looks down -z)
#   pred  = f * (1 + k1 |pn|^2 + k2 |pn|^4) * pn
#   r     = sqrt_info * (pred - obs)
# --------------------------------------------------------------------------


def _snavely(data, T, pt, f, k1, k2, compute_jacobians):
    """Snavely projection core of the fixed-intrinsics and the 9-dof BAL
    kernels: returns (r, S, p, pn, r2, d) with S = sqrt_info @
    d pred/d p_cam (None when Jacobians are skipped)."""
    p = se3.act(T, pt)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    inv_z = 1.0 / z
    pn = -p[..., :2] * inv_z[..., None]
    r2 = torch.sum(pn * pn, dim=-1)
    d = 1.0 + r2 * (k1 + k2 * r2)
    pred = (f * d)[..., None] * pn
    r = _bmv(data["sqrt_info"], pred - data["obs"])
    if not compute_jacobians:
        return r, None, p, pn, r2, d
    # d pn / d p_cam  (F, 2, 3)
    zeros = torch.zeros_like(x)
    J_pn = torch.stack(
        [
            torch.stack([-inv_z, zeros, x * inv_z * inv_z], dim=-1),
            torch.stack([zeros, -inv_z, y * inv_z * inv_z], dim=-1),
        ],
        dim=-2,
    )
    # d pred / d pn = f * (d * I + pn (dd/dpn)^T),  dd/dpn = 2(k1 + 2 k2 r2) pn
    dd = (2.0 * (k1 + 2.0 * k2 * r2))[..., None] * pn
    eye2 = torch.eye(2, dtype=pred.dtype, device=pred.device)
    J_pred = f[..., None, None] * (d[..., None, None] * eye2 + pn[..., :, None] * dd[..., None, :])
    S = data["sqrt_info"] @ J_pred @ J_pn  # (F, 2, 3)
    return r, S, p, pn, r2, d


@register_factor("reprojection_bal")
def reprojection_bal(data, T, pt, compute_jacobians=True):
    """Monocular BAL reprojection factor with radial distortion; the
    intrinsics ride in ``data`` as fixed per-observation scalars ``f``,
    ``k1``, ``k2``."""
    r, S, p, _, _, _ = _snavely(data, T, pt, data["f"], data["k1"], data["k2"], compute_jacobians)
    if not compute_jacobians:
        return r, None
    return r, (S @ se3.odot(p), S @ T[..., :3, :3])


def _balcam_pose(cam):
    return cam[..., :16].reshape(cam.shape[:-1] + (4, 4))


@register_factor("reprojection_bal9")
def reprojection_bal9(data, cam, pt, compute_jacobians=True):
    """Full BAL camera: the monocular radial-distortion reprojection with
    the intrinsics [f, k1, k2] optimized jointly with the pose.  ``cam`` is
    the (F, 19) ``bal_cam9`` storage [vec(T), f, k1, k2]."""
    T = _balcam_pose(cam)
    f, k1, k2 = cam[..., 16], cam[..., 17], cam[..., 18]
    r, S, p, pn, r2, d = _snavely(data, T, pt, f, k1, k2, compute_jacobians)
    if not compute_jacobians:
        return r, None
    J_T = S @ se3.odot(p)
    J_pt = S @ T[..., :3, :3]
    # intrinsics columns: d pred/df = d*pn; /dk1 = f r^2 pn; /dk2 = f r^4 pn
    J_intr = torch.stack(
        [d[..., None] * pn, (f * r2)[..., None] * pn, (f * r2 * r2)[..., None] * pn], dim=-1
    )  # (F, 2, 3)
    J_cam = torch.cat([J_T, data["sqrt_info"] @ J_intr], dim=-1)
    return r, (J_cam, J_pt)


@register_factor("prior_balcam_pose")
def prior_balcam_pose(data, cam, compute_jacobians=True):
    """Unary SE(3) prior on the POSE part of a ``bal_cam9`` camera (the gauge
    anchor of an optimized-intrinsics graph: freezing the whole 9-dof block
    would pin the anchor camera's intrinsics at their initial values)."""
    r, jacs = _prior(se3, data, _balcam_pose(cam), compute_jacobians)
    if not compute_jacobians:
        return r, None
    (J_pose,) = jacs
    return r, (torch.cat([J_pose, J_pose.new_zeros(J_pose.shape[:-1] + (3,))], dim=-1),)


# --------------------------------------------------------------------------
# Landmark SLAM: poses observing point landmarks, as a relative position
# (the landmark in the observing pose's frame) or as bearing + range.  T is
# world-to-body, so the body-frame landmark is p = act(T, l).
# --------------------------------------------------------------------------


def _wrap_angle(a):
    """Wrap to [-pi, pi]."""
    two_pi = 2.0 * math.pi
    return a - two_pi * torch.round(a / two_pi)


def _landmark_position(ops, n, data, T, l, compute_jacobians):
    """r = sqrt_info * (act(T, l) - obs) in n dimensions.  Left
    perturbation: d(exp(eps) T l)/d eps = odot(p); d p / d l = R."""
    p = ops.act(T, l)
    r = _bmv(data["sqrt_info"], p - data["obs"])
    if not compute_jacobians:
        return r, None
    return r, (data["sqrt_info"] @ ops.odot(p), data["sqrt_info"] @ T[..., :n, :n])


@register_factor("landmark_xy_se2")
def landmark_xy_se2(data, T, l, compute_jacobians=True):
    """Relative-position landmark factor (g2o EDGE_SE2_XY).  Slots: (se2
    pose, 2-dof euclidean landmark)."""
    return _landmark_position(se2, 2, data, T, l, compute_jacobians)


@register_factor("landmark_xyz_se3")
def landmark_xyz_se3(data, T, l, compute_jacobians=True):
    """3D relative-position landmark factor: the landmark observed as a
    body-frame position, no camera model.  Slots: (se3 pose, 3-dof
    euclidean landmark)."""
    return _landmark_position(se3, 3, data, T, l, compute_jacobians)


@register_factor("bearing_range_se2")
def bearing_range_se2(data, T, l, compute_jacobians=True):
    """Bearing-range landmark factor: with p = act(T, l) the body-frame
    landmark, r = sqrt_info * [wrap(atan2(p_y, p_x) - obs_bearing),
    |p| - obs_range].  Slots: (se2 pose, 2-dof euclidean landmark)."""
    p = se2.act(T, l)
    x, y = p[..., 0], p[..., 1]
    rho2 = x * x + y * y
    rho = torch.sqrt(rho2)
    raw = torch.stack(
        [_wrap_angle(torch.atan2(y, x) - data["obs"][..., 0]), rho - data["obs"][..., 1]], dim=-1
    )
    r = _bmv(data["sqrt_info"], raw)
    if not compute_jacobians:
        return r, None
    inv_rho2 = 1.0 / rho2
    inv_rho = 1.0 / rho
    # d[bearing, range]/dp  (F, 2, 2)
    J_p = torch.stack(
        [
            torch.stack([-y * inv_rho2, x * inv_rho2], dim=-1),
            torch.stack([x * inv_rho, y * inv_rho], dim=-1),
        ],
        dim=-2,
    )
    S = data["sqrt_info"] @ J_p
    return r, (S @ se2.odot(p), S @ T[..., :2, :2])


# --------------------------------------------------------------------------
# Quadratic curve fit: r = stiffness * (p0 x^2 + p1 x + p2 - y)
# --------------------------------------------------------------------------


@register_factor("quadratic")
def quadratic(data, p, compute_jacobians=True):
    """The reference's README example residual (``QuadraticResidual``)."""
    x, y, s = data["x"], data["y"], data["stiffness"]
    pred = p[..., 0] * x * x + p[..., 1] * x + p[..., 2]
    r = (s * (pred - y))[..., None]
    if not compute_jacobians:
        return r, None
    J = (s[..., None] * torch.stack([x * x, x, torch.ones_like(x)], dim=-1))[..., None, :]
    return r, (J,)


# --------------------------------------------------------------------------
# Euclidean prior: r = sqrt_info * (x - obs)
# --------------------------------------------------------------------------


@register_factor("prior_euclidean")
def prior_euclidean(data, x, compute_jacobians=True):
    """Unary prior on a euclidean element (a landmark position): the one
    kind that reaches the (landmark,) branch of ``ba_assemble``."""
    r = _bmv(data["sqrt_info"], x - data["obs"])
    if not compute_jacobians:
        return r, None
    return r, (data["sqrt_info"].expand(x.shape[:-1] + data["sqrt_info"].shape[-2:]),)


# --------------------------------------------------------------------------
# Chordal relaxation (pose-graph initialization, graph/initialize.py).  Both
# kinds are linear in their euclidean variables, so one exact GN step solves
# the relaxation through the standard assembly and solvers.
# --------------------------------------------------------------------------


@register_factor("chordal_rot")
def chordal_rot(data, x1, x2, compute_jacobians=True):
    """Rotation-relaxation factor: columns of R_j should equal R_meas @
    (columns of R_i), each rotation stored column-stacked as a d*d euclidean
    variable x = vec(R^T) (x.reshape(d, d)[c] = column c of R).

    r[c*d + a] = x2[c*d + a] - (R_meas @ x1[c*d : c*d+d])[a]
    """
    R = data["R_meas"]  # (F, d, d)
    d = R.shape[-1]
    F = x1.shape[0]
    X1 = x1.reshape(F, d, d)  # rows = columns of R_i
    X2 = x2.reshape(F, d, d)
    r = (X2 - X1 @ R.transpose(-1, -2)).reshape(F, d * d)
    if not compute_jacobians:
        return r, None
    eye = torch.eye(d, dtype=R.dtype, device=R.device)
    # J1[f, c*d+a, c'*d+b] = -delta_cc' * R[f, a, b]
    J1 = -torch.einsum("ck,fab->fcakb", eye, R).reshape(F, d * d, d * d)
    J2 = torch.eye(d * d, dtype=R.dtype, device=R.device).expand(F, d * d, d * d)
    return r, (J1, J2)


@register_factor("chordal_trans")
def chordal_trans(data, t1, t2, compute_jacobians=True):
    """Translation-recovery factor with rotations held fixed:
    r = t_j - R_meas @ t_i - t_meas (linear in the d-dof translations)."""
    R = data["R_meas"]
    r = t2 - _bmv(R, t1) - data["t_meas"]
    if not compute_jacobians:
        return r, None
    F, d = r.shape
    J2 = torch.eye(d, dtype=R.dtype, device=R.device).expand(F, d, d)
    return r, (-R, J2)
