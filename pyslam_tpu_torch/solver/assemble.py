"""Normal-equation assembly: H = J^T W J, g = -J^T W r, chi2.

Counterpart of ``pyslam_tpu/solver/assemble.py``: ``linearize_batch``,
``free_mask``, the dense assembly ``assemble_dense``,
``unit_diag_where_dead`` and ``gradient_and_chi2``.

The reference's dense assembly scatter-adds every factor's blocks into H
(``H.at[rows, cols].add(C)``), the semantics of its ``scatter_matmul``
kernel.  Here the scatter is the deterministic ``slot_reduce`` kernel over
a plan built once per graph structure on the host (``dense_plan``): the
block contributions are grouped by shape, each group is reduced onto its
unique destination blocks, and the reduced blocks are written into the
zeroed H with a plain, non-accumulating ``index_put_``.  No two writes
touch the same entry of H, so the result is the same on every run (CUDA's
``index_put_(accumulate=True)`` sums with atomics and is not).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.core import FactorGraph
from .cuda_ops import slot_plan, slot_reduce
from .plan_cache import ClosureCache, content_key


def linearize_batch(fb, blocks):
    """Evaluate one factor batch: residuals, Jacobians, fused IRLS weights,
    and its robustified cost contribution."""
    r, jacs = fb.evaluate(blocks, compute_jacobians=True)
    # A kernel's per-slot Jacobian width must equal the slot's manifold dof;
    # otherwise its columns would land in the wrong tangent entries and the
    # solve would converge to silent garbage.
    for s, (slot, J) in enumerate(zip(fb.slots, jacs)):
        dof = blocks[slot].dof
        if J.shape[-1] != dof:
            raise ValueError(
                f"factor kind {fb.kind!r} slot {s} ({slot!r}): Jacobian "
                f"width {J.shape[-1]} != block dof {dof} (kind "
                f"{blocks[slot].kind!r}).  A Lie-group parameter passed as "
                f"a raw array is inferred 'euclidean' — wrap it in the "
                f"matching group type (SE2/SE3/Sim3/...)"
            )
    w = fb.loss.weight(r) * fb.weight[:, None]
    chi2 = torch.sum(fb.loss.loss(r) * fb.weight[:, None])
    return r, jacs, w, chi2


def free_mask(graph: FactorGraph) -> torch.Tensor:
    """(D,) bool — False where the variable element is held constant."""
    segs = [torch.repeat_interleave(~b.const_mask, b.dof) for b in graph.blocks.values()]
    return torch.cat(segs)


# --------------------------------------------------------------------------
# Dense assembly plan
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DenseGroup:
    """The contributions of one block shape and where they go: the
    ``slot_reduce`` plan over their unique destination blocks (int32, on
    the graph's device) and ``pos``, the flat positions in H (or g) of
    every entry of every destination block, in the kernel's output order
    (int64, (n_slots * C,))."""

    shape: tuple  # (rows, cols) of a Hessian block, (dof,) of a gradient row
    perm: torch.Tensor
    offsets: torch.Tensor
    n_slots: int
    pos: torch.Tensor
    longest: int | None = None  # the plan's longest segment (``slot_reduce``'s ``longest``)


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """Static dense-assembly plan of one graph structure."""

    D: int
    h_groups: tuple  # DenseGroup per Hessian block shape
    g_groups: tuple  # DenseGroup per gradient row width


def _group(shape, keys, D, device):
    """``keys``: the flat top-left position in H (or g) of every
    contribution of one shape, in stacking order."""
    uniq, dest = np.unique(keys, return_inverse=True)
    sp = slot_plan(dest.reshape(-1), len(uniq))
    if len(shape) == 2:
        r, c = uniq // D, uniq % D
        pos = (r[:, None, None] + np.arange(shape[0])[None, :, None]) * D + (
            c[:, None, None] + np.arange(shape[1])[None, None, :]
        )
    else:
        pos = uniq[:, None] + np.arange(shape[0])[None, :]

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=device)

    return DenseGroup(
        tuple(shape), t(sp.perm, np.int32), t(sp.offsets, np.int32), len(uniq), t(pos.reshape(-1), np.int64),
        sp.longest,
    )


def dense_plan(graph: FactorGraph, hessian: bool = True) -> DensePlan:
    """Build the dense-assembly plan on the host (numpy) and put its index
    tensors on the graph's device.  Contributions are grouped by shape in
    the order ``dense_contributions`` stacks them: over the batches, for each
    slot pair (a, b) with b >= a, the F blocks C_ab to (row_a, row_b) and
    then, for a != b, the F blocks C_abᵀ to (row_b, row_a); and for the
    gradient, each slot's F rows to its rows.  With ``hessian=False`` only
    the gradient groups are built.  Raises on a factor index outside its
    block, which the reference would clamp silently."""
    D = graph.total_dof
    offsets = graph.offsets()
    device = next(iter(graph.blocks.values())).values.device
    h_keys: dict[tuple, list] = {}
    g_keys: dict[tuple, list] = {}
    for fb in graph.batches:
        rows, dofs = [], []
        for slot, idx in zip(fb.slots, fb.indices):
            blk = graph.blocks[slot]
            i = idx.detach().cpu().numpy().astype(np.int64)
            if len(i) and (i.min() < 0 or i.max() >= blk.n):
                raise ValueError(
                    f"factor batch {fb.kind!r} slot {slot!r}: index out of range "
                    f"[0, {blk.n}) (min {i.min()}, max {i.max()})"
                )
            rows.append(offsets[slot] + i * blk.dof)
            dofs.append(blk.dof)
            g_keys.setdefault((blk.dof,), []).append(rows[-1])
        if not hessian:
            continue
        for a in range(len(rows)):
            for b in range(a, len(rows)):
                h_keys.setdefault((dofs[a], dofs[b]), []).append(rows[a] * D + rows[b])
                if b != a:
                    h_keys.setdefault((dofs[b], dofs[a]), []).append(rows[b] * D + rows[a])
    return DensePlan(
        D,
        tuple(_group(s, np.concatenate(k), D, device) for s, k in h_keys.items()),
        tuple(_group(s, np.concatenate(k), D, device) for s, k in g_keys.items()),
    )


def structure_key(graph: FactorGraph) -> tuple:
    """What a dense plan depends on, by content: the device, every block's
    name, kind, size and tangent dimension, every batch's kind, slots and
    index tensors
    (``plan_cache.content_key``: a tensor is read and hashed once in its
    life, so a graph rebuilt around the same index tensors costs no read)."""
    return (
        str(next(iter(graph.blocks.values())).values.device),
        tuple((n, b.kind, b.n, b.dof) for n, b in graph.blocks.items()),
        tuple((fb.kind, tuple(fb.slots), tuple(content_key(i) for i in fb.indices)) for fb in graph.batches),
    )


_PLANS = ClosureCache()


def cached_dense_plan(graph: FactorGraph) -> DensePlan:
    """``dense_plan(graph)``, reused across calls on graphs of one structure
    (``structure_key``): a solve of a graph rebuilt every call, as a VO
    frame's levels are, builds its plan once."""
    key = structure_key(graph)
    if key not in _PLANS:
        _PLANS[key] = dense_plan(graph)
    return _PLANS[key]


# --------------------------------------------------------------------------
# Assembly
# --------------------------------------------------------------------------


def dense_contributions(graph: FactorGraph, hessian: bool, problems: int | None = None):
    """Linearize every batch: ({shape: [(F, C) block contributions]},
    {(dof,): [(F, dof) rows J^T W r]}, chi2), in the order of
    ``dense_plan`` (and, for one block kind, of ``bcsr.build_slot_plans``).
    With ``problems`` = B, the graph holds B problems of equal size side by
    side (``batched.py``: every batch the B problems' factors one problem
    after the other) and chi2 is each problem's, (B,)."""
    blocks0 = next(iter(graph.blocks.values())).values
    chi2 = torch.zeros(() if problems is None else (problems,), dtype=blocks0.dtype, device=blocks0.device)
    h_parts: dict[tuple, list] = {}
    g_parts: dict[tuple, list] = {}
    for fb in graph.batches:
        r, jacs, w, c2 = linearize_batch(fb, graph.blocks)
        if problems is not None:
            c2 = (fb.loss.loss(r) * fb.weight[:, None]).reshape(problems, -1).sum(1)
        chi2 = chi2 + c2
        wr = w * r
        for J in jacs:
            g_parts.setdefault((J.shape[-1],), []).append((J.transpose(1, 2) @ wr[..., None])[..., 0])
        if not hessian:
            continue
        for a in range(len(jacs)):
            for b in range(a, len(jacs)):
                C = jacs[a].transpose(1, 2) @ (w[..., None] * jacs[b])  # (F, da, db)
                # flatten, not reshape(F, -1): a batch may hold no factor
                h_parts.setdefault(tuple(C.shape[1:]), []).append(C.flatten(1))
                if b != a:
                    Ct = C.transpose(1, 2)
                    h_parts.setdefault(tuple(Ct.shape[1:]), []).append(Ct.flatten(1))
    return h_parts, g_parts, chi2


def _reduce_into(flat, groups, parts, sign):
    """Sum each group's contributions onto its destinations (``slot_reduce``)
    and write ``sign`` times the sums into ``flat``: one kernel call per
    group."""
    for grp in groups:
        contrib = torch.cat(parts[grp.shape]).contiguous()
        out = slot_reduce(contrib, grp.perm, grp.offsets, grp.n_slots, grp.longest).reshape(-1)
        flat.index_put_((grp.pos,), sign * out)


def assemble_dense(graph: FactorGraph, plan: DensePlan | None = None):
    """Full dense H (D, D), g (D,), chi2.  Constant parameters get zeroed
    rows/cols and a unit diagonal so their tangent update is exactly 0.
    ``plan`` (from ``dense_plan``) is built here when not given."""
    if plan is None:
        plan = dense_plan(graph)
    D = plan.D
    blocks0 = next(iter(graph.blocks.values())).values
    dtype, device = blocks0.dtype, blocks0.device
    h_parts, g_parts, chi2 = dense_contributions(graph, hessian=True)
    H = torch.zeros((D, D), dtype=dtype, device=device)
    g = torch.zeros(D, dtype=dtype, device=device)
    _reduce_into(H.view(-1), plan.h_groups, h_parts, 1.0)
    _reduce_into(g, plan.g_groups, g_parts, -1.0)

    # in place, so the masking adds no temporary the size of H
    free = free_mask(graph).to(dtype)
    H.mul_(free[:, None])
    H.mul_(free[None, :])
    H.diagonal().add_(1.0 - free)
    # NOTE: dead free dofs (no factor touches them) keep their zero diagonal
    # HERE — fixing them per-assembly would corrupt a factor-parallel path,
    # where shard-local assemblies are summed and a dof dead on one shard is
    # live globally.  Consumers that factorize a FULLY-REDUCED H apply
    # unit_diag_where_dead just before the factorization.
    g.mul_(free)
    return H, g, chi2


def unit_diag_where_dead_(H):
    """In place: a unit diagonal on exactly-zero diagonal entries.  Returns H."""
    d = H.diagonal()
    d.add_((d == 0.0).to(H.dtype))
    return H


def unit_diag_where_dead(H):
    """H + unit diagonal on exactly-zero diagonal entries: dead free dofs
    (e.g. an unobserved landmark) keep Cholesky defined; their gradient is
    0 so their update stays exactly 0.  Apply only to a fully-reduced H.
    Returns a new matrix."""
    return unit_diag_where_dead_(H.clone())


def gradient_and_chi2(graph: FactorGraph):
    """g and chi2 without forming H (used by diagnostics)."""
    plan = dense_plan(graph, hessian=False)
    blocks0 = next(iter(graph.blocks.values())).values
    _, g_parts, chi2 = dense_contributions(graph, hessian=False)
    g = torch.zeros(plan.D, dtype=blocks0.dtype, device=blocks0.device)
    _reduce_into(g, plan.g_groups, g_parts, -1.0)
    return g * free_mask(graph).to(g.dtype), chi2
