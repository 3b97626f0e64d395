"""Numeric utilities.

Counterpart of ``pyslam_tpu/utils.py``: ``invsqrt``, ``stackmul``,
``bilinear_interpolate``, ``pack_corners``, ``bilinear_interpolate_packed``
and ``kahan_sum``, on torch tensors on any device.
"""

from __future__ import annotations

import torch


def invsqrt(A):
    """Matrix inverse square root of an SPD matrix (or batch): Sigma ->
    stiffness, the weight that whitens a measurement covariance.  By a
    symmetric eigendecomposition; broadcasts over leading batch dims."""
    A = torch.as_tensor(A)
    if A.dim() == 0:
        return 1.0 / torch.sqrt(A)
    w, V = torch.linalg.eigh(A)
    w = torch.clamp(w, min=1e-30)
    return torch.einsum("...ik,...k,...jk->...ij", V, 1.0 / torch.sqrt(w), V)


def stackmul(A, B):
    """Batched matrix multiply over leading dims."""
    return torch.matmul(A, B)


def _corners(u, v, H, W):
    """Top-left integer corner (clamped so the 2x2 stencil stays inside)
    and the fractional offsets, clamped to [0, 1].  A NaN coordinate
    gathers at corner 0 and gets NaN offsets, so its sample is NaN (the
    reference's clamped gather); converting NaN to an integer would give an
    index outside the image."""
    u0 = torch.clamp(torch.floor(u), 0, W - 2)
    v0 = torch.clamp(torch.floor(v), 0, H - 2)
    au = torch.clamp(u - u0, 0.0, 1.0)
    av = torch.clamp(v - v0, 0.0, 1.0)
    return torch.nan_to_num(u0, nan=0.0).long(), torch.nan_to_num(v0, nan=0.0).long(), au, av


def _blend(f00, f01, f10, f11, au, av, compute_gradients):
    top = f00 + au * (f01 - f00)
    bot = f10 + au * (f11 - f10)
    val = top + av * (bot - top)
    if not compute_gradients:
        return val
    grad_u = (f01 - f00) + av * ((f11 - f10) - (f01 - f00))
    grad_v = bot - top
    return val, grad_u, grad_v


def bilinear_interpolate(im, u, v, compute_gradients: bool = False):
    """Bilinearly sample image ``im`` (H, W) or (H, W, C) at float pixel
    coordinates ``u`` (x / col) and ``v`` (y / row), both (...,).

    Returns the values and, with ``compute_gradients``, the image-space
    gradients d/du and d/dv (the photometric residual's analytic
    Jacobian).  Out-of-bounds samples clamp to the border; validity is the
    caller's mask."""
    im, u, v = torch.as_tensor(im), torch.as_tensor(u), torch.as_tensor(v)
    u0, v0, au, av = _corners(u, v, im.shape[0], im.shape[1])
    if im.dim() == 3:
        au = au[..., None]
        av = av[..., None]
    return _blend(im[v0, u0], im[v0, u0 + 1], im[v0 + 1, u0], im[v0 + 1, u0 + 1], au, av, compute_gradients)


def pack_corners(im):
    """(H, W) image -> (H*W, 4) per-pixel corner tuples
    [f(v,u), f(v,u+1), f(v+1,u), f(v+1,u+1)] with edge padding, so that a
    bilinear sample is one gather of a row instead of four
    (``bilinear_interpolate_packed``)."""
    r = torch.cat([im, im[-1:]], dim=0)
    r = torch.cat([r, r[:, -1:]], dim=1)
    return torch.stack([r[:-1, :-1], r[:-1, 1:], r[1:, :-1], r[1:, 1:]], dim=-1).reshape(-1, 4)


def bilinear_interpolate_packed(im4, H, W, u, v, compute_gradients: bool = False):
    """``bilinear_interpolate`` from a ``pack_corners`` layout: one gather.

    im4: (H*W, 4); u, v: (...,) float pixel coords.  The same arithmetic,
    and so the same bits, as the four-gather version."""
    u, v = torch.as_tensor(u), torch.as_tensor(v)
    u0, v0, au, av = _corners(u, v, H, W)
    quad = im4[(v0 * W + u0).reshape(-1)].reshape(u.shape + (4,))
    return _blend(quad[..., 0], quad[..., 1], quad[..., 2], quad[..., 3], au, av, compute_gradients)


def kahan_sum(x, chunk: int = 4096):
    """Compensated (Neumaier) summation of a flat tensor in its own dtype.

    Each chunk is summed by ``torch.sum`` (pairwise), then the chunk sums
    are added one after the other with a running compensation, which
    brings the error to O(1) ulp of the total.  Nothing on the solver paths
    uses it; it is for reductions of very many similarly-signed terms in
    f32."""
    x = x.reshape(-1)
    pad = (-x.shape[0]) % chunk
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    parts = torch.sum(x.reshape(-1, chunk), dim=1)
    s = x.new_zeros(())
    c = x.new_zeros(())
    for p in parts:
        t = s + p
        # Neumaier: the rounding error of the larger-magnitude operand
        c = c + torch.where(torch.abs(s) >= torch.abs(p), (s - t) + p, (p - t) + s)
        s = t
    return s + c
