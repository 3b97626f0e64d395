"""Variable marginalization: fold variables OUT of a graph, not drop them.

Counterpart of ``pyslam_tpu/graph/marginalize.py``.  ``marginalize(graph,
targets)`` removes the target variables and replaces every factor touching
them with one dense Gaussian prior over their Markov blanket: the Schur
complement of the consumed information, linearized at the current
estimates (first-estimate Jacobians).

Design, as in the reference:

* The structural edit is host numpy in f64: the weight-mask split of the
  batches, the Cholesky check of H_mm, the Schur complement, its eigen
  square root, the block rebuild and the index remap.  It reshapes the
  problem once; it is not a per-iteration path.
* The consumed subgraph's H and g come from ``solver.assemble_dense`` on
  the graph's device (its sums are the ``slot_reduce`` kernel there); the
  rows and columns of the targets and their blanket are gathered on the
  device and read back in one transfer.
* The output is an ordinary ``FactorGraph`` on the graph's device whose
  prior rides a registered kernel, ``dense_prior__<kinds>``:
      r(x) = A @ eta(x) - c,   eta_i = log(x_i * x0_i^-1)  (left tangent)
  with frozen linearization points x0, A and c from the eigen square root
  of the Schur complement (H' = A^T A, c = A^-T b') with its null
  directions (gauge freedoms of the consumed subgraph) truncated.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lie import se2, se3, sim3, so2, so3
from ..losses import L2Loss
from .core import FACTOR_KERNELS, FactorBatch, FactorGraph, VariableBlock

_PRIOR_OPS = {"se3": se3, "se2": se2, "sim3": sim3, "so3": so3}
PRIOR_PREFIX = "dense_prior__"


def _ensure_dense_prior_kernel(kinds: tuple) -> str:
    """Register (once) the batched dense-prior kernel for this slot
    kind-signature and return its registry name."""
    name = PRIOR_PREFIX + "_".join(kinds)
    if name in FACTOR_KERNELS:
        return name

    def kernel(data, *vals, compute_jacobians=True):
        etas, jls = [], []
        for i, kind in enumerate(kinds):
            x = vals[i]
            x0 = data[f"x0_{i}"]
            if kind == "euclidean":
                eta = (x - x0).reshape(x.shape[0], -1)
                d = eta.shape[-1]
                jl = torch.eye(d, dtype=x.dtype, device=x.device).expand(eta.shape[0], d, d)
            elif kind == "so2":
                eta = so2.log(x @ so2.inv(x0))[..., None]
                jl = torch.ones(eta.shape[:-1] + (1, 1), dtype=x.dtype, device=x.device)
            else:
                ops = _PRIOR_OPS[kind]
                eta = ops.log(x @ ops.inv(x0))
                jl = ops.inv_left_jacobian(eta)
            etas.append(eta)
            jls.append(jl)
        eta = torch.cat(etas, dim=-1)  # (F, m)
        r = (data["A"] @ eta[..., None])[..., 0] - data["c"]
        if not compute_jacobians:
            return r, None
        jacs, off = [], 0
        for i in range(len(kinds)):
            d = etas[i].shape[-1]
            jacs.append(data["A"][..., :, off : off + d] @ jls[i])  # (F, m, d)
            off += d
        return r, tuple(jacs)

    FACTOR_KERNELS[name] = kernel
    return name


def _dof_span(graph: FactorGraph, block: str, idx: int):
    off = graph.offsets()[block]
    d = graph.blocks[block].dof
    start = off + idx * d
    return np.arange(start, start + d)


def _host(t):
    return t.detach().cpu().numpy()


def marginalize(graph: FactorGraph, targets: dict, rank_tol: float = 1e-10):
    """Marginalize ``targets`` ({block_name: [indices]}) out of ``graph``.

    Returns a new FactorGraph, on the graph's device, in which the target
    variables are REMOVED (blocks shrunk, factor indices remapped), every
    factor touching them is consumed, and one dense-prior factor over their
    Markov blanket carries the consumed information (Schur complement at
    the current estimates).

    Raises ValueError for an unknown block, for constant targets
    (marginalizing the gauge anchor would make the prior rank-deficient —
    keep the anchor, or transfer it to a unary prior first) and for targets
    whose consumed subgraph leaves them unconstrained (singular H_mm).
    """
    from ..solver.assemble import assemble_dense

    targets = {k: np.atleast_1d(np.asarray(v, np.int64)) for k, v in targets.items()}
    const = {}
    for bname, idxs in targets.items():
        if bname not in graph.blocks:
            raise ValueError(f"unknown block {bname!r}")
    for bname, blk in graph.blocks.items():
        const[bname] = _host(blk.const_mask)
    for bname, idxs in targets.items():
        if const[bname][idxs].any():
            raise ValueError(
                f"cannot marginalize constant variables in {bname!r} "
                "(transfer the gauge to a prior on a kept variable first)"
            )
    tset = {(b, int(i)) for b, idxs in targets.items() for i in idxs}

    # ---- split every batch into consumed rows (touch a target) and kept
    # rows, with WEIGHT masks, never by slicing the data: per-factor and
    # batch-shared data (an unbatched sqrt_info, a camera) are not told
    # apart by shape, and weight-0 rows are inert in every solver path.
    # The kept batch therefore retains dead rows; their indices (which may
    # point at removed variables) are clamped to 0.
    consumed_batches, kept_parts = [], []
    blanket = set()
    for fb in graph.batches:
        idx_np = [_host(ix).astype(np.int64) for ix in fb.indices]
        w_np = _host(fb.weight)
        touch = np.zeros(fb.n, bool)
        for s, bname in enumerate(fb.slots):
            if bname in targets:
                touch |= np.isin(idx_np[s], targets[bname])
        if not touch.any():
            kept_parts.append((fb, None))
            continue
        touch_t = torch.tensor(touch, dtype=fb.weight.dtype, device=fb.weight.device)
        consumed_batches.append(FactorBatch(fb.kind, fb.slots, fb.indices, fb.data, fb.loss, fb.weight * touch_t))
        if (~touch & (w_np > 0)).any():
            kept_parts.append((fb, touch))
        live = touch & (w_np > 0)
        for s, bname in enumerate(fb.slots):
            for i in idx_np[s][live]:
                key = (bname, int(i))
                if key not in tset and not const[bname][int(i)]:
                    blanket.add(key)

    blanket = sorted(blanket)

    # ---- linearize the consumed subgraph at the current estimates (FEJ)
    if consumed_batches:
        lin = FactorGraph(dict(graph.blocks), consumed_batches)
        H_dev, b_dev, _ = assemble_dense(lin)
        M = np.concatenate([_dof_span(graph, bn, i) for bn, idxs in targets.items() for i in idxs])
        K = (np.concatenate([_dof_span(graph, bn, i) for bn, i in blanket]) if blanket
             else np.zeros(0, np.int64))
        sel = np.concatenate([M, K])
        sel_t = torch.tensor(sel, device=H_dev.device)
        sub = torch.cat([H_dev[sel_t][:, sel_t].reshape(-1), b_dev[sel_t]])
        sub = _host(sub).astype(np.float64)  # the one read
        n_sel, m = len(sel), len(M)
        H = sub[: n_sel * n_sel].reshape(n_sel, n_sel)
        b = sub[n_sel * n_sel :]
        Hmm = H[:m, :m]
        # unconstrained targets -> singular Hmm; detected before inverting,
        # even with an empty blanket (silently discarding the consumed
        # information of an underconstrained target breaks the contract)
        try:
            np.linalg.cholesky(Hmm)
        except np.linalg.LinAlgError:
            raise ValueError(
                "marginalization targets are not fully constrained by "
                "their adjacent factors (singular H_mm)"
            )
        if blanket:
            HmmI_B = np.linalg.solve(Hmm, H[:m, m:])
            Hp = H[m:, m:] - H[m:, :m] @ HmmI_B
            bp = b[m:] - H[m:, :m] @ np.linalg.solve(Hmm, b[:m])
            Hp = 0.5 * (Hp + Hp.T)
            # eigen square root; the consumed subgraph's gauge directions
            # (zero eigenvalues) are truncated instead of poisoning A
            w, V = np.linalg.eigh(Hp)
            wmax = max(w.max(), 0.0)
            pos = w > rank_tol * max(wmax, 1.0)
            sqw = np.where(pos, np.sqrt(np.clip(w, 0.0, None)), 0.0)
            A = sqw[:, None] * V.T  # A^T A == Hp (on the retained spectrum)
            with np.errstate(divide="ignore"):
                isq = np.where(pos, 1.0 / np.where(pos, sqw, 1.0), 0.0)
            c = isq * (V.T @ bp)  # A^-T b' on the retained spectrum

    # ---- rebuild blocks without the targets; remap factor indices
    new_blocks = {}
    remap = {}
    for bname, blk in graph.blocks.items():
        drop = targets.get(bname)
        keep = np.ones(blk.n, bool)
        if drop is not None:
            keep[drop] = False
        remap[bname] = np.cumsum(keep) - 1
        if keep.all():
            new_blocks[bname] = blk
        else:
            kept = torch.tensor(np.flatnonzero(keep), device=blk.values.device)
            new_blocks[bname] = VariableBlock(blk.kind, blk.values[kept], blk.const_mask[kept])

    out_batches = []
    for fb, touch in kept_parts:
        need = any(bn in targets for bn in fb.slots)
        if not need and touch is None:
            out_batches.append(fb)
            continue
        new_indices = []
        for bn, ix in zip(fb.slots, fb.indices):
            ni = _host(ix).astype(np.int64)
            if bn in targets:
                ni = remap[bn][ni]
            if touch is not None:
                # consumed rows stay in the batch with weight 0 (inert);
                # their indices may point at removed variables -> clamp
                ni = np.where(touch, 0, ni)
            new_indices.append(torch.tensor(ni, dtype=torch.int64, device=ix.device))
        weight = fb.weight
        if touch is not None:
            weight = fb.weight * torch.tensor(~touch, dtype=fb.weight.dtype, device=fb.weight.device)
        out_batches.append(FactorBatch(fb.kind, fb.slots, tuple(new_indices), fb.data, fb.loss, weight))

    # ---- the dense prior factor over the blanket
    if consumed_batches and blanket:
        values0 = next(iter(graph.blocks.values())).values
        dtype, device = values0.dtype, values0.device
        kinds = tuple(graph.blocks[bn].kind for bn, _ in blanket)
        kname = _ensure_dense_prior_kernel(kinds)
        data = {"A": torch.tensor(A[None], dtype=dtype, device=device),
                "c": torch.tensor(c[None], dtype=dtype, device=device)}
        for s, (bn, i) in enumerate(blanket):
            data[f"x0_{s}"] = graph.blocks[bn].values[i : i + 1].to(dtype).clone()
        out_batches.append(
            FactorBatch.create(
                kind=kname,
                slots=tuple(bn for bn, _ in blanket),
                indices=tuple(np.array([remap[bn][i]], np.int64) for bn, i in blanket),
                data=data,
                loss=L2Loss(),
            )
        )

    return FactorGraph(new_blocks, out_batches)


__all__ = ["marginalize"]
