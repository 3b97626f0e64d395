"""SO(2) — planar rotations on torch tensors.

Counterpart of ``pyslam_tpu/lie/so2.py``, function for function.
Rotations are ``(..., 2, 2)`` tensors; all ops broadcast over leading batch
dimensions.
"""

from __future__ import annotations

import torch

from .._device import resolve_device

DOF = 1


def _angle(phi):
    """(...,) or (..., 1) angle -> (...,), the reference's squeeze rule."""
    if phi.dim() and phi.shape[-1] == 1:
        return phi[..., 0]
    return phi


def wedge(phi):
    """(...,) or (..., 1) angle -> (..., 2, 2) skew matrix."""
    phi = _angle(phi)
    zero = torch.zeros_like(phi)
    return torch.stack(
        [torch.stack([zero, -phi], dim=-1), torch.stack([phi, zero], dim=-1)], dim=-2
    )


def vee(Phi):
    """(..., 2, 2) -> (...,) angle."""
    return Phi[..., 1, 0]


def exp(phi):
    """(...,) angle -> (..., 2, 2) rotation matrix."""
    phi = _angle(phi)
    c, s = torch.cos(phi), torch.sin(phi)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def log(R):
    """(..., 2, 2) -> (...,) angle."""
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])


def inv(R):
    return R.transpose(-1, -2)


def mul(Ra, Rb):
    return Ra @ Rb


def act(R, p):
    return (R @ p[..., None])[..., 0]


def perturb(R, phi):
    """Left-multiplicative update exp(phi) @ R."""
    return exp(phi) @ R


def identity(dtype=torch.float32, batch_shape=(), device=None):
    """Identity elements on ``device`` (None: the package's default, the CUDA card)."""
    return torch.eye(2, dtype=dtype, device=resolve_device(device)).expand(tuple(batch_shape) + (2, 2))
