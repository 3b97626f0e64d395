"""SE(2) — planar rigid transforms on torch tensors.

Counterpart of ``pyslam_tpu/lie/se2.py``, function for function.
Transforms are ``(..., 3, 3)`` homogeneous matrices; tangent vectors are
``xi = [rho_x, rho_y, phi]``, translation first.  All ops broadcast over
leading batch dimensions.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from . import so2

DOF = 3
_SMALL = 1e-4

# The rotation generator J2 = [[0, -1], [1, 0]] enters only through the
# two helpers below, which build their results from the operands (a
# constant matrix would be a host-to-device copy, and PyTorch synchronises
# the stream after each such copy).  Multiplying by J2's 0 / +-1 entries is
# exact, so the results equal the reference's matrix products bit for bit.


def _J2_mv(v):
    """J2 @ v for (..., 2) v: [-v_y, v_x]."""
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def _aI_bJ2(a, b):
    """(...,), (...,) -> (..., 2, 2): a I + b J2 = [[a, -b], [b, a]]."""
    return torch.stack([torch.stack([a, -b], dim=-1), torch.stack([b, a], dim=-1)], dim=-2)


def _coeffs(phi):
    """Scalar series sin(x)/x, (1-cos x)/x, (1-cos x)/x^2, (x-sin x)/x^2,
    with the reference's Taylor branch below |x| = 1e-4."""
    x = phi
    x2 = x * x
    small = x2 < _SMALL**2
    sx = torch.sin(x)
    # 1 - cos(x) as 2 sin^2(x/2): accurate near pi
    omc = 2.0 * torch.square(torch.sin(0.5 * x))
    a = torch.where(small, 1.0 - x2 / 6.0, sx / torch.where(small, 1.0, x))
    b = torch.where(small, x / 2.0 - x * x2 / 24.0, omc / torch.where(small, 1.0, x))
    g = torch.where(small, 0.5 - x2 / 24.0, omc / torch.where(small, 1.0, x2))
    d = torch.where(small, x / 6.0 - x * x2 / 120.0, (x - sx) / torch.where(small, 1.0, x2))
    return a, b, g, d


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def wedge(xi):
    """(..., 3) -> (..., 3, 3): [[phi*J2, rho], [0, 0]]."""
    rho, phi = xi[..., :2], xi[..., 2]
    zero = torch.zeros_like(phi)
    row0 = torch.stack([zero, -phi, rho[..., 0]], dim=-1)
    row1 = torch.stack([phi, zero, rho[..., 1]], dim=-1)
    row2 = torch.stack([zero, zero, zero], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def vee(Xi):
    return torch.stack([Xi[..., 0, 2], Xi[..., 1, 2], Xi[..., 1, 0]], dim=-1)


def _V(phi):
    """The 2x2 'translation' Jacobian V(phi) = sin/x I + (1-cos)/x J2."""
    a, b, _, _ = _coeffs(phi)
    return _aI_bJ2(a, b)


def exp(xi):
    """Exponential map: (..., 3) -> (..., 3, 3)."""
    rho, phi = xi[..., :2], xi[..., 2]
    # phi[..., None]: so2.exp's (..., 1) squeeze then sees the trailing dof
    # axis and never eats a batch axis of length one
    R = so2.exp(phi[..., None])
    return _assemble(R, _mv(_V(phi), rho))


def log(T):
    """Logarithmic map: (..., 3, 3) -> (..., 3)."""
    R, t = T[..., :2, :2], T[..., :2, 2]
    phi = so2.log(R)
    a, b, _, _ = _coeffs(phi)
    # V^{-1} = 1/(a^2+b^2) [[a, b], [-b, a]]
    denom = a * a + b * b
    Vinv_t = torch.stack(
        [(a * t[..., 0] + b * t[..., 1]) / denom, (-b * t[..., 0] + a * t[..., 1]) / denom],
        dim=-1,
    )
    return torch.cat([Vinv_t, phi[..., None]], dim=-1)


def _bottom(batch_shape, like):
    last = torch.eye(3, dtype=like.dtype, device=like.device)[2:]  # [0, 0, 1]
    return last.expand(tuple(batch_shape) + (1, 3))


def _assemble(R, t):
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, _bottom(R.shape[:-2], R)], dim=-2)


def inv(T):
    R, t = T[..., :2, :2], T[..., :2, 2]
    Rt = R.transpose(-1, -2)
    return _assemble(Rt, -_mv(Rt, t))


def mul(Ta, Tb):
    return Ta @ Tb


def act(T, p):
    """Transform 2D points: (..., 3, 3) x (..., 2) -> (..., 2)."""
    return _mv(T[..., :2, :2], p) + T[..., :2, 2]


def adjoint(T):
    """(..., 3, 3) -> (..., 3, 3) adjoint: [[R, [t_y, -t_x]^T], [0, 1]]."""
    R, t = T[..., :2, :2], T[..., :2, 2]
    col = torch.stack([t[..., 1], -t[..., 0]], dim=-1)
    top = torch.cat([R, col[..., :, None]], dim=-1)
    return torch.cat([top, _bottom(T.shape[:-2], T)], dim=-2)


def odot(p):
    """(..., 2) point -> (..., 2, 3) matrix s.t. wedge(xi) @ [p;1] = odot(p) @ xi.

    odot(p) = [[1, 0, -p_y], [0, 1, p_x]].
    """
    one = torch.ones_like(p[..., 0])
    zero = torch.zeros_like(one)
    row0 = torch.stack([one, zero, -p[..., 1]], dim=-1)
    row1 = torch.stack([zero, one, p[..., 0]], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _u(rho, g, d):
    """The coupling column -(g I + d J2) J2 rho of the left Jacobian."""
    Jrho = _J2_mv(rho)
    return -(g[..., None] * Jrho + d[..., None] * _J2_mv(Jrho))


def left_jacobian(xi):
    """Left Jacobian of SE(2): (..., 3) -> (..., 3, 3).

    J_l = [[V(phi), (g I + d J2)(-J2 rho)], [0, 1]] with
    g = (1-cos)/phi^2, d = (phi-sin)/phi^2.
    """
    rho, phi = xi[..., :2], xi[..., 2]
    _, _, g, d = _coeffs(phi)
    top = torch.cat([_V(phi), _u(rho, g, d)[..., :, None]], dim=-1)
    return torch.cat([top, _bottom(xi.shape[:-1], xi)], dim=-2)


def inv_left_jacobian(xi):
    """Inverse left Jacobian: [[V, u],[0,1]]^-1 = [[V^-1, -V^-1 u],[0,1]]."""
    rho, phi = xi[..., :2], xi[..., 2]
    a, b, g, d = _coeffs(phi)
    u = _u(rho, g, d)
    denom = (a * a + b * b)[..., None, None]
    # V = a I + b J  =>  V^-1 = (a I - b J) / (a^2 + b^2)
    Vinv = _aI_bJ2(a, -b) / denom
    nu = -_mv(Vinv, u)
    top = torch.cat([Vinv, nu[..., :, None]], dim=-1)
    return torch.cat([top, _bottom(xi.shape[:-1], xi)], dim=-2)


def perturb(T, xi):
    """Left-multiplicative update exp(xi) @ T."""
    return exp(xi) @ T


def identity(dtype=torch.float32, batch_shape=(), device=None):
    """Identity elements on ``device`` (None: the package's default, the CUDA card)."""
    return torch.eye(3, dtype=dtype, device=resolve_device(device)).expand(tuple(batch_shape) + (3, 3))
