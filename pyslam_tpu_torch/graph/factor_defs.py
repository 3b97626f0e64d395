"""Batched residual + analytic-Jacobian kernels, one per factor kind.

Counterpart of ``pyslam_tpu/graph/factor_defs.py``.  Ported so far: the
pose priors and the relative-pose factors of SE(2), SE(3) and Sim(3), all
through the group-generic ``_prior`` / ``_between``.  Conventions are the
reference's:
  * residuals are pre-multiplied by ``sqrt_info``,
  * Jacobians are w.r.t. *left* perturbations exp(eps) * T,
  * the pose-to-pose measurement is T_2_1, with estimate
    T_2_1_est = T_2_0 * T_1_0^-1.

Every kernel returns ``(r, jacs)`` with r (F, m) and jacs a tuple of
(F, m, dof_slot) tensors (or ``(r, None)`` when Jacobians are skipped).
"""

from __future__ import annotations

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


@register_factor("between_sim3")
def between_sim3(data, S1, S2, compute_jacobians=True):
    """Sim(3) relative-similarity factor: the scale-drift-aware loop
    closure of monocular SLAM.  The 7th residual component is the log scale
    ratio."""
    return _between(sim3, data, S1, S2, compute_jacobians)
