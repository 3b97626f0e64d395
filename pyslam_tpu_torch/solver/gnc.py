"""Graduated non-convexity (GNC) for outlier-robust solving.

Counterpart of ``pyslam_tpu/solver/gnc.py`` (Yang, Antonante, Tzoumas,
Carlone, RA-L 2020).  GNC solves the truncated-least-squares or
Geman-McClure objective by graduating a surrogate from convex to the target
non-convexity, alternating

  1. a weighted least-squares solve on any solver path of the package: the
     weights ride the per-factor ``FactorBatch.weight`` tensor, so every
     inner solve sees one graph structure and new weight data (no plan or
     cache is keyed on the weights), and
  2. a closed-form per-factor weight update from the whitened residual
     norms at the current estimate, on the device.

The outer loop is a handful of host iterations.  Each reads the device
once: the TLS stop test (how far the weights are from binary) over every
robustified batch together.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..graph.core import FactorGraph
from ..losses import L2Loss
from .lm import Options


class GNCInfo(NamedTuple):
    chi2: float  # robustified (TLS / GM) cost at the solution
    outer_iters: int
    weights: list  # per robustified batch: (F,) final GNC weights in [0, 1] (numpy)
    inlier_masks: list  # per robustified batch: (F,) bool, weight > 0.5 (numpy)
    mu_history: list


def _r2_per_factor(graph: FactorGraph, batch_ids):
    """Whitened squared residual norm per factor for the selected batches
    (device tensors)."""
    out = []
    for bi in batch_ids:
        r, _ = graph.batches[bi].evaluate(graph.blocks, compute_jacobians=False)
        out.append(torch.sum(r * r, dim=-1))
    return out


def _gm_weights(r2, mu, c2):
    """Geman-McClure surrogate weights: w = (mu c2 / (r2 + mu c2))^2."""
    t = mu * c2 / (r2 + mu * c2)
    return t * t


def _tls_weights(r2, mu, c2):
    """Truncated-least-squares surrogate weights (closed form, RA-L 2020
    eq. 14): 1 below the inner threshold, 0 above the outer, the saddle
    interpolation between."""
    lo = mu / (mu + 1.0) * c2
    hi = (mu + 1.0) / mu * c2
    mid = torch.sqrt(c2 * mu * (mu + 1.0) / torch.clamp(r2, min=1e-30)) - mu
    w = torch.clamp(mid, 0.0, 1.0)
    w = torch.where(r2 <= lo, 1.0, w)
    return torch.where(r2 >= hi, 0.0, w)


def solve_gnc(
    graph: FactorGraph,
    options: Options | None = None,
    *,
    robustify=None,
    surrogate: str = "tls",
    c_sq: float | None = None,
    confidence: float = 0.99,
    mu_update: float = 1.4,
    max_outer: int = 30,
    inner_iters: int = 10,
    solve_fn=None,
):
    """Outlier-robust solve by graduated non-convexity.

    robustify: batch indices to apply GNC weights to (default: every batch
        whose factors touch two variables, loop closures and odometry;
        unary priors stay trusted).
    surrogate: 'tls' (default, hard inlier / outlier classification) or
        'gm'.  GM's start with mu large is plain L2, which locks into the
        L2 basin under heavy contamination; TLS's start with mu small
        downweights gross outliers from the first outer iteration.
    c_sq: squared inlier threshold on the whitened residual norm ||r||^2.
        Default: the ``confidence`` chi-square quantile for the batch's
        residual dimension (scipy), a Python number.
    solve_fn: (graph, options) -> (solved, info); defaults to
        ``solve_auto``.  It runs ``max_outer`` + 1 times at most, on one
        structure with new weights, with ``max_iters = inner_iters``.

    The robustified batches are solved under L2 (a robust kernel beneath
    would count the downweighting twice).  Returns (solved_graph,
    GNCInfo); the returned graph carries the final GNC weights in its
    batches, so its chi2 reflects the inlier set.
    """
    from scipy.stats import chi2 as _chi2_dist

    from . import solve_auto

    opts = options if options is not None else Options()
    inner_opts = dataclasses.replace(opts, max_iters=inner_iters)
    if solve_fn is None:
        solve_fn = solve_auto
    if robustify is None:
        robustify = [i for i, fb in enumerate(graph.batches) if len(fb.slots) == 2]
    if not robustify:
        raise ValueError("no batches to robustify")

    base_weights = [graph.batches[bi].weight for bi in robustify]
    rs = [graph.batches[bi].evaluate(graph.blocks, compute_jacobians=False)[0] for bi in robustify]
    r2_0 = [torch.sum(r * r, dim=-1) for r in rs]
    c2s = [float(c_sq) if c_sq is not None else float(_chi2_dist.ppf(confidence, r.shape[-1])) for r in rs]
    del rs

    def _with_weights(g, ws):
        batches = list(g.batches)
        for bi, w, bw in zip(robustify, ws, base_weights):
            batches[bi] = dataclasses.replace(batches[bi], loss=L2Loss(), weight=w * bw)
        return FactorGraph(dict(g.blocks), batches)

    upd = {"tls": _tls_weights, "gm": _gm_weights}[surrogate]

    # mu from the largest residual at the initial estimate (RA-L 2020 III):
    # GM starts deep in the convex regime (mu large), TLS near-convex (mu
    # small) and graduates up.  One host read.
    flat = torch.cat([x.reshape(-1) for x in r2_0]).cpu().numpy()
    parts = np.split(flat, np.cumsum([x.numel() for x in r2_0])[:-1])
    r2max = max(float(x.max()) if x.size else 1.0 for x in parts)
    mus = []
    for c2 in c2s:
        if surrogate == "gm":
            mus.append(max(2.0 * r2max / c2, 1.0))
        else:
            mus.append(max(c2 / max(2.0 * r2max - c2, 1e-9), 1e-6))

    ws = [torch.ones_like(x) for x in r2_0]
    mu_hist = []
    solved = graph
    outer = 0
    for outer in range(1, max_outer + 1):
        solved, _ = solve_fn(_with_weights(solved, ws), inner_opts)
        r2s = _r2_per_factor(solved, robustify)
        ws = [upd(r2, mu, c2) for r2, mu, c2 in zip(r2s, mus, c2s)]
        mu_hist.append(list(mus))
        if surrogate == "gm":
            if all(mu <= 1.0 + 1e-9 for mu in mus):
                break
            mus = [max(mu / mu_update, 1.0) for mu in mus]
        else:
            # converged when the weights are (numerically) binary: one read
            # for every robustified batch
            frac = float(sum(torch.abs(w - torch.round(w)).sum() for w in ws))
            if frac < 1e-3:
                break
            mus = [mu * mu_update for mu in mus]

    # final polish on the converged inlier weights
    solved, _ = solve_fn(_with_weights(solved, ws), inner_opts)
    solved = _with_weights(solved, ws)

    # robustified cost: the truncated TLS cost / the GM cost of each factor
    r2s = [x.cpu().numpy() for x in _r2_per_factor(solved, robustify)]
    chi2 = 0.0
    for r2, c2, bw in zip(r2s, c2s, base_weights):
        bw = bw.cpu().numpy()
        if surrogate == "tls":
            chi2 += float((np.minimum(r2, c2) * bw).sum())
        else:
            chi2 += float((c2 * r2 / (r2 + c2) * bw).sum())
    for i, fb in enumerate(solved.batches):
        if i in robustify:
            continue
        r, _ = fb.evaluate(solved.blocks, compute_jacobians=False)
        chi2 += float(torch.sum(fb.loss.loss(r) * fb.weight[:, None]))

    weights = [w.cpu().numpy() for w in ws]
    return solved, GNCInfo(
        chi2=chi2,
        outer_iters=outer,
        weights=weights,
        inlier_masks=[w > 0.5 for w in weights],
        mu_history=mu_hist,
    )


__all__ = ["solve_gnc", "GNCInfo"]
