"""SE(3) — rigid transforms on torch tensors.

Counterpart of ``pyslam_tpu/lie/se3.py``, function for function.
Transforms are ``(..., 4, 4)`` homogeneous matrices; tangent vectors are
``xi = [rho (3), phi (3)]``, translation first.  All ops broadcast over
leading batch dimensions.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from . import so3

DOF = 6
_SMALL = 1e-4


def wedge(xi):
    """(..., 6) -> (..., 4, 4): [[phi^, rho], [0, 0]]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    top = torch.cat([so3.wedge(phi), rho[..., :, None]], dim=-1)
    bottom = torch.zeros(xi.shape[:-1] + (1, 4), dtype=xi.dtype, device=xi.device)
    return torch.cat([top, bottom], dim=-2)


def vee(Xi):
    return torch.cat([Xi[..., :3, 3], so3.vee(Xi[..., :3, :3])], dim=-1)


def _blocks22(A, B, C, D):
    """[[A, B], [C, D]] from four (..., 3, 3) blocks."""
    return torch.cat([torch.cat([A, B], dim=-1), torch.cat([C, D], dim=-1)], dim=-2)


def curlywedge(xi):
    """(..., 6) -> (..., 6, 6) adjoint-algebra matrix [[phi^, rho^], [0, phi^]]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    P = so3.wedge(phi)
    return _blocks22(P, so3.wedge(rho), torch.zeros_like(P), P)


def exp(xi):
    """Exponential map: (..., 6) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3.exp(phi)
    t = (so3.left_jacobian(phi) @ rho[..., None])[..., 0]
    return _assemble(R, t)


def log(T):
    """Logarithmic map: (..., 4, 4) -> (..., 6)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3.log(R)
    rho = (so3.inv_left_jacobian(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def _assemble(R, t):
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # built on the device: a host-to-device copy would synchronise the stream
    last = torch.eye(4, dtype=R.dtype, device=R.device)[3:]  # [0, 0, 0, 1]
    bottom = last.expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def inv(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return _assemble(Rt, -(Rt @ t[..., None])[..., 0])


def mul(Ta, Tb):
    return Ta @ Tb


def act(T, p):
    """Transform 3D points: (..., 4, 4) x (..., 3) -> (..., 3)."""
    return (T[..., :3, :3] @ p[..., None])[..., 0] + T[..., :3, 3]


def rot(T):
    return T[..., :3, :3]


def trans(T):
    return T[..., :3, 3]


def adjoint(T):
    """(..., 4, 4) -> (..., 6, 6): [[R, t^ R], [0, R]] (for [rho, phi] order)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return _blocks22(R, so3.wedge(t) @ R, torch.zeros_like(R), R)


def odot(p, directional: bool = False):
    """(..., 3) point -> (..., 3, 6) s.t. wedge(xi) @ [p; w] = odot(p) @ xi.

    For a point (w=1): [I3, -p^]; for a direction (w=0): [0, -p^].
    """
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (3, 3))
    left = torch.zeros_like(eye) if directional else eye
    return torch.cat([left, -so3.wedge(p)], dim=-1)


def _Q_matrix(rho, phi):
    """Barfoot's Q matrix for the SE(3) left Jacobian (Barfoot Eq. 7.86b)."""
    rx = so3.wedge(rho)
    px = so3.wedge(phi)
    th2 = torch.sum(phi * phi, dim=-1)
    th = torch.sqrt(torch.clamp(th2, min=1e-24))
    small = th2 < _SMALL**2
    inv_t = 1.0 / torch.where(small, 1.0, th)
    sth, cth = torch.sin(th), torch.cos(th)
    inv3 = inv_t * inv_t * inv_t
    # 0.5*th2 + cth - 1 == 0.5*th2 - (1 - cth), with 1-cth via sin^2(th/2)
    omc = 2.0 * torch.square(torch.sin(0.5 * th))

    m2 = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - sth) * inv3)
    m3 = torch.where(small, 1.0 / 24.0 - th2 / 720.0, (0.5 * th2 - omc) * inv3 * inv_t)
    m4 = torch.where(
        small,
        1.0 / 120.0 - th2 / 2520.0,
        (th - 1.5 * sth + 0.5 * th * cth) * inv3 * inv_t * inv_t,
    )

    pr = px @ rx
    rp = rx @ px
    t2 = pr + rp + px @ rp
    pp = px @ px
    t3 = pp @ rx + rx @ pp - 3.0 * (pr @ px)
    t4 = (pr @ px) @ px + (pp @ rx) @ px

    def b(c):
        return c[..., None, None]

    return 0.5 * rx + b(m2) * t2 + b(m3) * t3 + b(m4) * t4


def left_jacobian(xi):
    """SE(3) left Jacobian: (..., 6) -> (..., 6, 6) = [[J(phi), Q], [0, J(phi)]]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    J = so3.left_jacobian(phi)
    return _blocks22(J, _Q_matrix(rho, phi), torch.zeros_like(J), J)


def inv_left_jacobian(xi):
    """Inverse SE(3) left Jacobian: [[Jinv, -Jinv Q Jinv], [0, Jinv]]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    Jinv = so3.inv_left_jacobian(phi)
    upper = -Jinv @ _Q_matrix(rho, phi) @ Jinv
    return _blocks22(Jinv, upper, torch.zeros_like(Jinv), Jinv)


def perturb(T, xi):
    """Left-multiplicative update exp(xi) @ T."""
    return exp(xi) @ T


def identity(dtype=torch.float32, batch_shape=(), device=None):
    """Identity elements on ``device`` (None: the package's default, the CUDA card)."""
    return torch.eye(4, dtype=dtype, device=resolve_device(device)).expand(tuple(batch_shape) + (4, 4))


def normalize(T):
    """Re-orthonormalize the rotation block (guards f32 drift over many
    compositions) via symmetric orthogonalization."""
    R = T[..., :3, :3]
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    u = torch.cat([u[..., :, :2], u[..., :, 2:] * torch.sign(det)[..., None, None]], dim=-1)
    return _assemble(u @ vt, T[..., :3, 3])
