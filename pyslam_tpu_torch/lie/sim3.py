"""Sim(3) — similarity transforms (rotation + translation + scale) on torch
tensors.

Counterpart of ``pyslam_tpu/lie/sim3.py``, function for function.
Representation: ``(..., 4, 4)`` matrices ``[[s*R, t], [0, 1]]``.  Tangent
vectors are ``xi = [rho (3), phi (3), sigma (1)]``: translation first,
log-scale last.

``exp``/``log`` use the closed-form ``W = a*I + b*phi^ + c*phi^2`` matrix
with Taylor branches for small sigma and small theta.  Every branch is
evaluated on guarded denominators and then selected, as in the reference,
so a branch that is not selected cannot put inf or NaN into the result.
``left_jacobian`` is the entire series sum_n ad^n/(n+1)!; its inverse uses
the block-triangular structure of ``ad``.  3x3 inverses and determinants
are closed forms (no batched LU).
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from . import so3

DOF = 7
_SMALL = 1e-3


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def wedge(xi):
    """(..., 7) -> (..., 4, 4): [[sigma*I + phi^, rho], [0, 0]]."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    A = so3.wedge(phi) + sigma[..., None, None] * _eye(3, xi)
    top = torch.cat([A, rho[..., :, None]], dim=-1)
    bottom = torch.zeros(xi.shape[:-1] + (1, 4), dtype=xi.dtype, device=xi.device)
    return torch.cat([top, bottom], dim=-2)


def vee(Xi):
    A = Xi[..., :3, :3]
    sigma = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    skew = A - sigma[..., None, None] * _eye(3, Xi)
    return torch.cat([Xi[..., :3, 3], so3.vee(skew), sigma[..., None]], dim=-1)


def _W_coeffs(sigma, theta):
    """Coefficients (a, b, c) of W = int_0^1 e^{sigma*u} exp(u*phi^) du
    = a*I + b*phi^ + c*phi^^2, with Taylor branches for each of the four
    (sigma small?) x (theta small?) regions.  All branches are evaluated on
    guarded denominators so no NaN leaks through torch.where."""
    sm_s = torch.abs(sigma) < _SMALL
    sm_t = theta < _SMALL
    # guarded denominators
    s = torch.where(sm_s, 1.0, sigma)
    th = torch.where(sm_t, 1.0, theta)
    es = torch.exp(sigma)
    s2t2 = s * s + th * th
    sth, cth = torch.sin(th), torch.cos(th)

    # ---- a = (e^s - 1)/s (theta-independent)
    a = torch.where(
        sm_s,
        1.0 + sigma / 2.0 + sigma * sigma / 6.0 + sigma**3 / 24.0,
        (es - 1.0) / s,
    )

    # ---- b = int e^{su} sin(u th)/th du ; c = (a - int e^{su} cos(u th) du)/th^2
    b_gen = (th + es * (s * sth - th * cth)) / (th * s2t2)
    c_gen = (a - (es * (s * cth + th * sth) - s) / s2t2) / (th * th)
    # theta -> 0 (sigma general): b = (e^s(s-1)+1)/s^2 ; c = (e^s(s^2-2s+2)-2)/(2 s^3)
    b_t = (es * (s - 1.0) + 1.0) / (s * s)
    c_t = (es * (s * s - 2.0 * s + 2.0) - 2.0) / (2.0 * s**3)
    # sigma -> 0 (theta general): first order in sigma
    omc = 2.0 * torch.square(torch.sin(0.5 * th))  # 1 - cos, free of cancellation
    b_s = omc / (th * th) + sigma * (sth - th * cth) / th**3
    c_s = (th - sth) / th**3 + sigma * (0.5 - (cth + th * sth - 1.0) / (th * th)) / (th * th)
    # both small: second-order Taylor
    t2 = theta * theta
    b_ts = 0.5 + sigma / 3.0 - t2 / 24.0 - sigma * t2 / 30.0
    c_ts = 1.0 / 6.0 + sigma / 8.0 - t2 / 120.0 - sigma * t2 / 144.0

    both = sm_s & sm_t
    b = torch.where(both, b_ts, torch.where(sm_t, b_t, torch.where(sm_s, b_s, b_gen)))
    c = torch.where(both, c_ts, torch.where(sm_t, c_t, torch.where(sm_s, c_s, c_gen)))
    return a, b, c


def _W(sigma, phi):
    """(...,), (..., 3) -> (..., 3, 3) closed-form W matrix."""
    theta = torch.sqrt(torch.clamp(torch.sum(phi * phi, dim=-1), min=1e-24))
    a, b, c = _W_coeffs(sigma, theta)
    px = so3.wedge(phi)
    return a[..., None, None] * _eye(3, phi) + b[..., None, None] * px + c[..., None, None] * (px @ px)


def _inv3(M):
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _det3(M):
    """Closed-form batched 3x3 determinant (cofactor expansion along row 0)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def exp(xi):
    """Exponential map: (..., 7) -> (..., 4, 4) [[e^sigma R, W rho], [0, 1]]."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3.exp(phi)
    t = _mv(_W(sigma, phi), rho)
    return _assemble(torch.exp(sigma)[..., None, None] * R, t)


def log(S):
    """Logarithmic map: (..., 4, 4) -> (..., 7)."""
    sR, t = S[..., :3, :3], S[..., :3, 3]
    s = scale(S)
    sigma = torch.log(s)
    R = sR / s[..., None, None]
    phi = so3.log(R)
    rho = _mv(_inv3(_W(sigma, phi)), t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def _assemble(sR, t):
    top = torch.cat([sR, t[..., :, None]], dim=-1)
    last = torch.eye(4, dtype=sR.dtype, device=sR.device)[3:]  # [0, 0, 0, 1]
    return torch.cat([top, last.expand(sR.shape[:-2] + (1, 4))], dim=-2)


def scale(S):
    """Scale factor s = det(s*R)^(1/3)."""
    det = _det3(S[..., :3, :3])
    return torch.sign(det) * torch.abs(det) ** (1.0 / 3.0)


def rot(S):
    """Unit rotation block R (scale divided out)."""
    return S[..., :3, :3] / scale(S)[..., None, None]


def trans(S):
    return S[..., :3, 3]


def inv(S):
    sR, t = S[..., :3, :3], S[..., :3, 3]
    s2 = torch.sum(sR[..., 0, :] * sR[..., 0, :], dim=-1)  # (s^2) row norm
    sRinv = sR.transpose(-1, -2) / s2[..., None, None]  # (1/s) R^T
    return _assemble(sRinv, -_mv(sRinv, t))


def mul(Sa, Sb):
    return Sa @ Sb


def act(S, p):
    """Similarity-transform 3D points: s R p + t."""
    return _mv(S[..., :3, :3], p) + S[..., :3, 3]


def adjoint(S):
    """(..., 4, 4) -> (..., 7, 7): [[sR, t^ R, -t], [0, R, 0], [0, 0, 1]]
    (for [rho, phi, sigma] tangent order): S exp(xi) S^-1 = exp(Ad(S) xi)."""
    sR, t = S[..., :3, :3], S[..., :3, 3]
    R = rot(S)
    tR = so3.wedge(t) @ R
    z33 = torch.zeros_like(R)
    z31 = torch.zeros(S.shape[:-2] + (3, 1), dtype=S.dtype, device=S.device)
    row0 = torch.cat([sR, tR, -t[..., :, None]], dim=-1)
    row1 = torch.cat([z33, R, z31], dim=-1)
    return torch.cat([row0, row1, _last_row7(S.shape[:-2], S)], dim=-2)


def _last_row7(batch_shape, like):
    last = torch.eye(7, dtype=like.dtype, device=like.device)[6:]  # [0, ..., 0, 1]
    return last.expand(tuple(batch_shape) + (1, 7))


def _ad(xi):
    """Algebra adjoint: (..., 7) -> (..., 7, 7)
    [[sigma I + phi^, rho^, -rho], [0, phi^, 0], [0, 0, 0]]."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    P = so3.wedge(phi)
    A = P + sigma[..., None, None] * _eye(3, xi)
    z33 = torch.zeros_like(A)
    z = torch.zeros(xi.shape[:-1] + (3, 1), dtype=xi.dtype, device=xi.device)
    row0 = torch.cat([A, so3.wedge(rho), -rho[..., :, None]], dim=-1)
    row1 = torch.cat([z33, P, z], dim=-1)
    row2 = torch.zeros(xi.shape[:-1] + (1, 7), dtype=xi.dtype, device=xi.device)
    return torch.cat([row0, row1, row2], dim=-2)


_JL_TERMS = 26  # entire series; first dropped term ||ad||^27/28! < 1e-11 at ||ad|| = 4.5


def left_jacobian(xi):
    """Sim(3) left Jacobian J_l(xi) = sum_n ad(xi)^n / (n+1)!  (..., 7, 7),
    as a fixed ``_JL_TERMS``-term Horner sum (exact to f64 roundoff at any
    argument the solver sees)."""
    A = _ad(xi)
    eye = _eye(7, xi)
    # Scaled Horner for sum_{n=0..N} A^n/(n+1)!:  H_N = I,
    # H_{k-1} = I + (A H_k)/(k+1)  =>  H_0 = I/1! + A/2! + A^2/3! + ...
    J = eye.expand(A.shape)
    for n in range(_JL_TERMS, 0, -1):
        J = eye + (A @ J) / float(n + 1)
    return J


def inv_left_jacobian(xi):
    """Inverse Sim(3) left Jacobian, exact via block-triangular inversion.

    J_l = [[P, X, y], [0, Q, 0], [0, 0, 1]] with P = W(sigma, phi) and
    Q = J_so3(phi), so
      J_l^-1 = [[P^-1, -P^-1 X Q^-1, -P^-1 y], [0, Q^-1, 0], [0, 0, 1]]
    with P^-1 by 3x3 adjugate and Q^-1 the closed-form SO(3) inverse left
    Jacobian."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    J = left_jacobian(xi)
    X, y = J[..., :3, 3:6], J[..., :3, 6]
    Pinv = _inv3(_W(sigma, phi))
    Qinv = so3.inv_left_jacobian(phi)
    upper = -Pinv @ X @ Qinv
    ncol = -_mv(Pinv, y)
    z33 = torch.zeros_like(Pinv)
    z31 = torch.zeros(xi.shape[:-1] + (3, 1), dtype=xi.dtype, device=xi.device)
    row0 = torch.cat([Pinv, upper, ncol[..., :, None]], dim=-1)
    row1 = torch.cat([z33, Qinv, z31], dim=-1)
    return torch.cat([row0, row1, _last_row7(xi.shape[:-1], xi)], dim=-2)


def perturb(S, xi):
    """Left-multiplicative update exp(xi) @ S."""
    return exp(xi) @ S


def identity(dtype=torch.float32, batch_shape=(), device=None):
    """Identity elements on ``device`` (None: the package's default, the CUDA card)."""
    return torch.eye(4, dtype=dtype, device=resolve_device(device)).expand(tuple(batch_shape) + (4, 4))


def normalize(S):
    """Re-orthonormalize the rotation block, preserving scale and
    translation (guards f32 drift over many compositions)."""
    s = scale(S)
    R = S[..., :3, :3] / s[..., None, None]
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    u = torch.cat([u[..., :, :2], u[..., :, 2:] * torch.sign(det)[..., None, None]], dim=-1)
    return _assemble(s[..., None, None] * (u @ vt), S[..., :3, 3])


def from_se3(T, s=1.0):
    """Embed an SE(3) transform (or batch) as Sim(3) with scale s."""
    s = torch.as_tensor(s, dtype=T.dtype, device=T.device)
    return _assemble(s[..., None, None] * T[..., :3, :3], T[..., :3, 3])


def to_se3(S):
    """Project to SE(3) by dropping scale (rotation renormalized)."""
    return _assemble(rot(S), S[..., :3, 3])
