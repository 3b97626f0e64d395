"""Timestamp association and SE(3) pose interpolation for trajectory
evaluation.

Counterpart of ``pyslam_tpu/eval/sync.py``: ``associate`` (greedy
nearest-timestamp matching, the TUM benchmark's protocol) and
``interpolate_poses`` (geodesic resampling in SE(3)), with two repairs:

  * ``associate`` builds its candidate pairs with numpy (the reference
    loops over every (estimate, reference) pair in Python) and returns the
    reference's index arrays, ties included: candidates are ordered by
    (gap, reference index, estimate index), as the reference sorts its
    tuples;
  * ``interpolate_poses`` raises ValueError on stamps that are not
    strictly increasing, where the reference interpolates between the
    wrong poses without a word.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..lie import se3


def associate(t_ref, t_est, max_dt: float = 0.02, offset: float = 0.0):
    """Greedy nearest-timestamp matching (the TUM benchmark's protocol).

    ``offset`` is added to ``t_est`` before matching (clock skew).
    Returns (idx_ref, idx_est): index arrays of equal length, each index
    used at most once, |t_ref[i] - (t_est[j] + offset)| <= max_dt, chosen
    globally best first (by gap, then reference index, then estimate
    index), sorted by the reference index."""
    t_ref = np.asarray(t_ref, np.float64)
    t_est = np.asarray(t_est, np.float64) + offset
    # sort internally (searchsorted needs it; logs are not always ordered)
    # and map the matches back to the caller's indices
    ref_order = np.argsort(t_ref, kind="stable")
    t_ref_s = t_ref[ref_order]
    # candidate pairs: for each estimate stamp, EVERY reference stamp
    # within max_dt (the two bracketing neighbours are not enough when a
    # greedy earlier match consumes them)
    lo = np.searchsorted(t_ref_s, t_est - max_dt, side="left")
    hi = np.searchsorted(t_ref_s, t_est + max_dt, side="right")
    counts = np.maximum(hi - lo, 0)
    j = np.repeat(np.arange(len(t_est)), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    i_s = np.repeat(lo, counts) + (np.arange(len(j)) - first)
    dt = np.abs(t_ref_s[i_s] - t_est[j])
    i = ref_order[i_s]
    order = np.lexsort((j, i, dt))
    used_i = np.zeros(len(t_ref), bool)
    used_j = np.zeros(len(t_est), bool)
    out_i, out_j = [], []
    for a, b in zip(i[order].tolist(), j[order].tolist()):
        if used_i[a] or used_j[b]:
            continue
        used_i[a] = used_j[b] = True
        out_i.append(a)
        out_j.append(b)
    sort = np.argsort(out_i) if out_i else []
    return np.asarray(out_i, np.int64)[sort], np.asarray(out_j, np.int64)[sort]


def interpolate_poses(T, t, t_query, extrapolate: bool = False, device=None):
    """Resample an SE(3) trajectory at new timestamps.

    ``T`` (N, 4, 4) poses at strictly increasing stamps ``t`` (N,); returns
    (M, 4, 4) numpy poses at ``t_query`` by geodesic interpolation between
    the bracketing poses: T(u) = exp(u * log(T_b T_a^-1)) @ T_a, computed in
    float64 on ``device`` (None: ``default_device()``). Raises ValueError
    on stamps that are not strictly increasing, and on queries outside
    [t[0], t[-1]] unless ``extrapolate`` (then they clamp to the end
    poses)."""
    t = np.asarray(t, np.float64)
    tq = np.asarray(t_query, np.float64)
    if np.any(~(np.diff(t) > 0)):
        k = int(np.flatnonzero(~(np.diff(t) > 0))[0])
        raise ValueError(f"trajectory stamps are not strictly increasing: t[{k}] = {t[k]}, t[{k + 1}] = {t[k + 1]}")
    if not extrapolate and (tq.min() < t[0] or tq.max() > t[-1]):
        raise ValueError(
            f"query stamps [{tq.min()}, {tq.max()}] outside trajectory "
            f"[{t[0]}, {t[-1]}]; pass extrapolate=True to clamp"
        )
    tq = np.clip(tq, t[0], t[-1])
    hi = np.clip(np.searchsorted(t, tq, side="right"), 1, len(t) - 1)
    lo = hi - 1
    denom = np.maximum(t[hi] - t[lo], 1e-12)
    u = (tq - t[lo]) / denom
    dev = resolve_device(device)
    Td = torch.as_tensor(np.array(T.detach().cpu() if torch.is_tensor(T) else T), dtype=torch.float64).to(dev)
    lo_d, hi_d = torch.as_tensor(lo, device=dev), torch.as_tensor(hi, device=dev)
    Ta, Tb = Td[lo_d], Td[hi_d]
    xi = se3.log(Tb @ se3.inv(Ta))  # (M, 6)
    Tq = se3.exp(torch.as_tensor(u, device=dev)[:, None] * xi) @ Ta
    return Tq.cpu().numpy()


__all__ = ["associate", "interpolate_poses"]
