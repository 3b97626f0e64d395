"""Plane-sweep stereo block matching on the device.

Counterpart of ``pyslam_tpu/pipelines/stereo_match.py``: ``block_match``,
the port's disparity stage for ``compute_disparity(matcher="tpu")``.

  * the costs of a chunk of disparity hypotheses at once: the right image
    shifted by each d, the absolute difference, the SAD over a
    (2r+1)^2 window from an integral image (``_box_sum``);
  * then the reference's sweep over the hypotheses in order, one step a
    hypothesis on (H, W) maps: winner-take-all, the costs at best-1 and
    best+1 for the subpixel parabola, and the second-best cost outside
    +-1 of the best, whose rules depend on the order of the sweep;
  * validity: texture (windowed deviation from the window mean),
    uniqueness (second-best / best), border and disparity range; invalid
    pixels are NaN.

Memory is O(_CHUNK · H · W). Every float operation is the reference's, in
float32 by default; the integral image's prefix sums add in the order of the
reference's CPU backend (``_cumsum``), so the two agree bit for bit there,
and the costs that break ties and decide validity are the same numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._device import resolve_device

# XLA's CPU backend rewrites a prefix sum into prefix sums over blocks of
# this length, nested (the order the reference's numbers are recorded in)
_SCAN_BLOCK = 16
# hypotheses costed at once (memory O(_CHUNK · H · W)); the result does not
# depend on it
_CHUNK = 16


def _seq_cumsum(x, dim):
    """Prefix sum along ``dim`` (a short axis), added left to right."""
    parts = [x.select(dim, 0)]
    for k in range(1, x.shape[dim]):
        parts.append(parts[-1] + x.select(dim, k))
    return torch.stack(parts, dim=dim)


def _cumsum(x, dim):
    """Inclusive prefix sum of ``x`` along ``dim`` in a fixed order: blocks
    of 16 summed left to right, the block totals prefix-summed the same way
    (recursively), each block's exclusive prefix added last. This is the
    order of the reference's ``jnp.cumsum`` on XLA's CPU backend, so the
    integral images match it bit for bit on any device (``torch.cumsum``
    adds float32 in float64 on the CPU and by a parallel scan on CUDA)."""
    y = x.movedim(dim, 0)
    n = y.shape[0]
    if n <= _SCAN_BLOCK:
        return _seq_cumsum(y, 0).movedim(0, dim)
    m = -(-n // _SCAN_BLOCK)
    pad = y.new_zeros((m * _SCAN_BLOCK - n,) + tuple(y.shape[1:]))
    inner = _seq_cumsum(torch.cat([y, pad]).reshape((m, _SCAN_BLOCK) + tuple(y.shape[1:])), 1)
    pref = _cumsum(inner[:, -1], 0)
    excl = torch.cat([torch.zeros_like(pref[:1]), pref[:-1]])
    out = (inner + excl[:, None]).reshape((m * _SCAN_BLOCK,) + tuple(y.shape[1:]))[:n]
    return out.movedim(0, dim)


def _box_sum(x, r):
    """(..., H, W) -> windowed sums over (2r+1)^2 from an integral image;
    windows are cropped at the borders."""
    H, W = x.shape[-2], x.shape[-1]
    ii = F.pad(_cumsum(_cumsum(x, -2), -1), (1, 0, 1, 0))
    dev = x.device
    r0 = torch.clamp(torch.arange(H, device=dev) - r, 0, H)
    r1 = torch.clamp(torch.arange(H, device=dev) + r + 1, 0, H)
    c0 = torch.clamp(torch.arange(W, device=dev) - r, 0, W)
    c1 = torch.clamp(torch.arange(W, device=dev) + r + 1, 0, W)
    lo, hi = ii[..., r0, :], ii[..., r1, :]
    return hi[..., c1] - lo[..., c1] - hi[..., c0] + lo[..., c0]


def block_match(
    im_left,
    im_right,
    num_disparities: int = 64,
    block_radius: int = 7,
    uniqueness_ratio: float = 1.10,
    texture_threshold: float = 0.5,
    dtype=torch.float32,
    device=None,
):
    """Disparity map (H, W) for a rectified pair, in ``dtype`` (float32, the
    reference's); invalid pixels NaN.

    The convention of OpenCV's StereoBM: disparity d means left(x, y) ~
    right(x - d, y), d in [0, num_disparities). Tensors are matched on their
    device; arrays on ``device`` (None: ``default_device()``)."""
    dev = im_left.device if torch.is_tensor(im_left) else resolve_device(device)
    L = torch.as_tensor(im_left).to(dev, dtype)
    R = torch.as_tensor(im_right).to(dev, dtype)
    H, W = L.shape
    r = block_radius
    big = 1e30
    cols = torch.arange(W, device=dev)

    best_c = torch.full((H, W), big, dtype=dtype, device=dev)
    best_d = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    c_bm1, c_bp1, second_c, prev_c = (torch.full((H, W), big, dtype=dtype, device=dev) for _ in range(4))
    for d0 in range(0, num_disparities, _CHUNK):
        ds = torch.arange(d0, min(num_disparities, d0 + _CHUNK), device=dev)
        # the right image shifted by each d (the reference's roll, its
        # wrapped-around left edge zeroed)
        Rs = R[:, (cols[None, :] - ds[:, None]) % W].permute(1, 0, 2)  # (C, H, W)
        Rs = torch.where(cols[None, None, :] >= ds[:, None, None], Rs, 0.0)
        sad = _box_sum(torch.abs(L[None] - Rs), r)
        sad = torch.where(cols[None, None, :] >= ds[:, None, None] + r, sad, big)
        for k in range(sad.shape[0]):
            d = d0 + k
            c = sad[k]
            new_best = c < best_c
            # parabola neighbours: the cost at best-1 is the previous
            # hypothesis's when the best is replaced; the cost at best+1
            # arrives with the next hypothesis
            c_bm1 = torch.where(new_best, prev_c, c_bm1)
            c_bp1 = torch.where(new_best, big, c_bp1)
            c_bp1 = torch.where(~new_best & (best_d == d - 1), c, c_bp1)
            # second-best outside +-1 of the best, for uniqueness
            far = torch.abs(d - best_d) > 1
            second_c = torch.where(~new_best & far & (c < second_c), c, second_c)
            second_c = torch.where(new_best & (best_c < second_c) & (d - best_d > 1), best_c, second_c)
            best_d = torch.where(new_best, d, best_d)
            best_c = torch.where(new_best, c, best_c)
            prev_c = c

    # subpixel parabola: offset = (c- - c+) / (2 (c- - 2 c0 + c+))
    cm, c0, cp = c_bm1, best_c, c_bp1
    interior = (cm < big) & (cp < big)
    denom = cm - 2.0 * c0 + cp
    offset = torch.where(interior & (denom > 1e-12), (cm - cp) / (2.0 * torch.clamp(denom, min=1e-12)), 0.0)
    disp = best_d.to(dtype) + torch.clamp(offset, -0.5, 0.5)

    n_win = _box_sum(torch.ones((H, W), dtype=dtype, device=dev), r)
    texture = _box_sum(torch.abs(L - _box_sum(L, r) / n_win), r)
    valid = (
        (best_d >= 0)
        & (best_c < big)
        & (second_c >= best_c * uniqueness_ratio)
        & (texture > texture_threshold)
        & (cols[None, :] >= num_disparities + r)
    )
    return torch.where(valid, disp, float("nan"))


__all__ = ["block_match"]
