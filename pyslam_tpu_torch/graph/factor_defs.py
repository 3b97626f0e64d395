"""Batched residual + analytic-Jacobian kernels, one per factor kind.

Counterpart of ``pyslam_tpu/graph/factor_defs.py``.  Ported so far: the
SE(3) pose prior and the SE(3) relative-pose factor.  Conventions are the
reference's:
  * residuals are pre-multiplied by ``sqrt_info``,
  * Jacobians are w.r.t. *left* perturbations exp(eps) * T,
  * the pose-to-pose measurement is T_2_1, with estimate
    T_2_1_est = T_2_0 * T_1_0^-1.

Every kernel returns ``(r, jacs)`` with r (F, m) and jacs a tuple of
(F, m, dof_slot) tensors (or ``(r, None)`` when Jacobians are skipped).
"""

from __future__ import annotations

from ..lie import se3
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
