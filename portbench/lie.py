"""SO(3) and SE(3) in plain PyTorch, for the benchmark's generators and
plain references.  Written from the textbook formulas (Barfoot, "State
Estimation for Robotics", ch. 7), independent of the program under test.

Poses are (..., 4, 4) matrices, tangents xi = [rho (3), phi (3)],
translation first, and an update is left-multiplicative: exp(xi) T.
Every matrix product goes through ``mm``, so that a reference can run its
products in another precision (``arith.Arith.mm``)."""

from __future__ import annotations

import torch

# below this squared angle the closed forms give way to their series
_SMALL2 = 1e-8


def wedge(phi):
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)


def vee(S):
    return torch.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], -1)


def _eye(like, n=3):
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(like.shape[:-1] + (n, n))


def _coeffs(phi):
    """(theta^2, sin(t)/t, (1 - cos t)/t^2, (t - sin t)/t^3), each by its
    series below ``_SMALL2``."""
    t2 = (phi * phi).sum(-1)
    small = t2 < _SMALL2
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    a = torch.where(small, 1 - t2 / 6, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24, 2 * torch.sin(0.5 * t) ** 2 / (t * t))
    c = torch.where(small, 1 / 6 - t2 / 120, (t - torch.sin(t)) / (t * t * t))
    return t2, a, b, c


def so3_exp(phi, mm=torch.matmul):
    """Rodrigues: I + a [phi] + b [phi]^2."""
    _, a, b, _ = _coeffs(phi)
    P = wedge(phi)
    return _eye(phi) + a[..., None, None] * P + b[..., None, None] * mm(P, P)


def so3_log(R):
    """The rotation vector of R, the angle by atan2 (accurate near 0)."""
    s = 0.5 * vee(R - R.transpose(-1, -2))  # sin(theta) * axis
    sn = torch.linalg.vector_norm(s, dim=-1)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1)
    theta = torch.atan2(sn, c)
    small = sn < 1e-12
    scale = torch.where(small, 1 + sn * sn / 6, theta / torch.where(small, torch.ones_like(sn), sn))
    return scale[..., None] * s


def se3_exp(xi, mm=torch.matmul):
    rho, phi = xi[..., :3], xi[..., 3:]
    _, a, b, c = _coeffs(phi)
    P = wedge(phi)
    PP = mm(P, P)
    R = _eye(phi) + a[..., None, None] * P + b[..., None, None] * PP
    V = _eye(phi) + b[..., None, None] * P + c[..., None, None] * PP
    return assemble(R, mm(V, rho[..., None])[..., 0])


def se3_log(T, mm=torch.matmul):
    """[V(phi)^-1 t, phi], V^-1 = I - [phi]/2 + k [phi]^2,
    k = (1 - (t sin t) / (2 (1 - cos t))) / t^2."""
    phi = so3_log(T[..., :3, :3])
    t2 = (phi * phi).sum(-1)
    small = t2 < _SMALL2
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    # 1 - cos t as 2 sin^2(t/2), which keeps its digits at small angles
    k = torch.where(small, 1 / 12 + t2 / 720, (1 - t * torch.sin(t) / (4 * torch.sin(0.5 * t) ** 2)) / (t * t))
    P = wedge(phi)
    Vinv = _eye(phi) - 0.5 * P + k[..., None, None] * mm(P, P)
    return torch.cat([mm(Vinv, T[..., :3, 3:])[..., 0], phi], -1)


def assemble(R, t):
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1
    return torch.cat([top, bottom], -2)


def se3_inv(T, mm=torch.matmul):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return assemble(Rt, -mm(Rt, T[..., :3, 3:])[..., 0])


def generators(dtype, device):
    """The six (4, 4) generators G_k of se(3): d/d xi_k exp(xi) at 0."""
    G = torch.zeros(6, 4, 4, dtype=dtype, device=device)
    for k in range(3):
        G[k, k, 3] = 1
    G[3:, :3, :3] = wedge(torch.eye(3, dtype=dtype, device=device))
    return G
