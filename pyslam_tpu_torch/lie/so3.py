"""SO(3) — rotation group on torch tensors.

Counterpart of ``pyslam_tpu/lie/so3.py``, function for function.
Rotations are plain ``(..., 3, 3)`` tensors and every function broadcasts
over leading batch dimensions.  The small-angle and theta ~ pi branches
keep the reference's select-with-safe-denominator form, so no branch that
is not selected can produce inf or NaN.
"""

from __future__ import annotations

import math

import torch

DOF = 3

# Angle below which Taylor series replace the closed forms (as in the
# reference: the dropped term is below f32 epsilon).
_SMALL = 1e-4


def _unsqueeze(x, n=2):
    """Append ``n`` singleton dims (for broadcasting scalars over matrices)."""
    return x.reshape(x.shape + (1,) * n)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def wedge(phi):
    """(..., 3) axis-angle vector -> (..., 3, 3) skew-symmetric matrix."""
    zero = torch.zeros_like(phi[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -phi[..., 2], phi[..., 1]], dim=-1),
            torch.stack([phi[..., 2], zero, -phi[..., 0]], dim=-1),
            torch.stack([-phi[..., 1], phi[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def vee(Phi):
    """(..., 3, 3) skew-symmetric matrix -> (..., 3) vector."""
    return torch.stack([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]], dim=-1)


def _theta(phi):
    """Rotation angle, floored so sqrt stays finite in its derivative at 0."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-24))
    return theta, theta_sq


def _one_minus_cos(theta):
    """1 - cos(theta) as 2 sin^2(theta/2): accurate near pi, where the
    trace-based form loses digits."""
    s = torch.sin(0.5 * theta)
    return 2.0 * s * s


def exp(phi):
    """Exponential map: (..., 3) -> (..., 3, 3) via Rodrigues' formula."""
    theta, theta_sq = _theta(phi)
    small = theta_sq < _SMALL**2
    inv_t = 1.0 / torch.where(small, 1.0, theta)

    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks.
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) * inv_t)
    b = torch.where(small, 0.5 - theta_sq / 24.0, _one_minus_cos(theta) * inv_t * inv_t)

    W = wedge(phi)
    W2 = W @ W
    return _eye(3, phi) + _unsqueeze(a) * W + _unsqueeze(b) * W2


def log(R):
    """Logarithmic map: (..., 3, 3) -> (..., 3) axis-angle, robust over the
    full angle range including theta ~ pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    skew = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    # sin(theta) from the skew part: exact to rounding where arccos of the
    # trace is ill-conditioned (theta near 0 or pi).
    sin_theta = 0.5 * torch.sqrt(torch.clamp(torch.sum(skew * skew, dim=-1), min=1e-24))
    theta = torch.atan2(sin_theta, cos_theta)
    theta_sq = theta * theta

    small = theta < _SMALL
    near_pi = theta > math.pi - 1e-3

    # Generic branch: phi = theta / (2 sin theta) * skew, with the Taylor
    # form 0.5 + theta^2/12 near zero.
    factor_generic = torch.where(
        small,
        0.5 + theta_sq / 12.0,
        theta / (2.0 * torch.where(small, 1.0, sin_theta)),
    )
    phi_generic = _unsqueeze(factor_generic, 1) * skew

    # Near-pi branch: recover the axis from the symmetric part,
    #   B = (R + R^T)/2 - cos_theta * I = (1 - cos_theta) aa^T.
    B = 0.5 * (R + R.transpose(-1, -2)) - _unsqueeze(cos_theta) * _eye(3, R)
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    omc = torch.where(near_pi, 1.0 - cos_theta, 1.0)  # >= ~2 when selected
    axis_abs = torch.sqrt(torch.clamp(diag / _unsqueeze(omc, 1), min=1e-12))
    # Signs from row k of B (k = largest component, first on ties):
    # B_kj = (1-cos) a_k a_j, so with a_k > 0, sign(a_j) = sign(B_kj).
    k = torch.argmax(axis_abs, dim=-1)
    index = k[..., None, None].expand(k.shape + (1, 3))
    row_k = torch.gather(B, -2, index)[..., 0, :]
    axis_pi = torch.where(row_k >= 0.0, axis_abs, -axis_abs)
    # Overall sign from the skew part while it still carries one; at
    # exactly pi the sign is a gauge freedom (+1 here).
    flip = torch.sum(axis_pi * skew, dim=-1) < 0.0
    axis_pi = torch.where(_unsqueeze(flip, 1), -axis_pi, axis_pi)
    phi_pi = _unsqueeze(theta, 1) * axis_pi

    return torch.where(_unsqueeze(near_pi, 1), phi_pi, phi_generic)


def left_jacobian(phi):
    """Left Jacobian J_l(phi): (..., 3) -> (..., 3, 3).

    J_l = I + (1-cos t)/t^2 W + (t - sin t)/t^3 W^2.
    """
    theta, theta_sq = _theta(phi)
    small = theta_sq < _SMALL**2
    inv_t = 1.0 / torch.where(small, 1.0, theta)
    a = torch.where(small, 0.5 - theta_sq / 24.0, _one_minus_cos(theta) * inv_t * inv_t)
    b = torch.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (theta - torch.sin(theta)) * inv_t * inv_t * inv_t
    )
    W = wedge(phi)
    W2 = W @ W
    return _eye(3, phi) + _unsqueeze(a) * W + _unsqueeze(b) * W2


def inv_left_jacobian(phi):
    """Inverse left Jacobian J_l^{-1}(phi): (..., 3) -> (..., 3, 3).

    J_l^{-1} = I - W/2 + (1/t^2 - (1 + cos t)/(2 t sin t)) W^2.
    """
    theta, theta_sq = _theta(phi)
    small = theta_sq < _SMALL**2
    half = theta * 0.5
    # cot expression: 1/t^2 - cos(t/2)/(2 t sin(t/2)); Taylor: 1/12 + t^2/720.
    inv_t = 1.0 / torch.where(small, 1.0, theta)
    inv_sin_half = 1.0 / torch.where(small, 1.0, torch.sin(half))
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        inv_t * inv_t - 0.5 * torch.cos(half) * inv_sin_half * inv_t,
    )
    W = wedge(phi)
    W2 = W @ W
    return _eye(3, phi) - 0.5 * W + _unsqueeze(cot_term) * W2


def inv(R):
    """Group inverse (transpose)."""
    return R.transpose(-1, -2)


def mul(Ra, Rb):
    """Group composition."""
    return Ra @ Rb


def act(R, p):
    """Rotate points: (..., 3, 3) x (..., 3) -> (..., 3)."""
    return (R @ p[..., None])[..., 0]


def perturb(R, phi):
    """Left-multiplicative update exp(phi) @ R."""
    return exp(phi) @ R


def identity(dtype=torch.float32, batch_shape=(), device="cpu"):
    return torch.eye(3, dtype=dtype, device=device).expand(tuple(batch_shape) + (3, 3))
