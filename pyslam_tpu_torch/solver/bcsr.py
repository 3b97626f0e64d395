"""Direct-to-ELL normal equations + block-Jacobi PCG for large pose graphs.

Counterpart of the ``solve_ell`` path of ``pyslam_tpu/solver/bcsr.py``.
The Hessian is stored in a symmetric ELL layout, He (nb, K, d, d): for each
pose r, K neighbour blocks with the diagonal block pinned at slot 0, so
that Marquardt damping and the block-Jacobi preconditioner read He[:, 0]
as a slice.

Per LM iteration:
  * assembly (``assemble_ell``): factor linearization in plain tensor code,
    then two calls of the ``slot_reduce`` kernel — one reduces every
    factor's JᵀWJ blocks into their ELL slots, one reduces the gradient
    rows into their poses.  The order of each reduction is fixed by a plan
    sorted once on the host (``SlotPlan``), so the result does not change
    from run to run;
  * Marquardt damping of the slot-0 blocks and the closed-form 6×6
    block-Jacobi inverse (``sym_block_inv``), plain tensor code;
  * PCG (``linear.pcg_solve``) whose matvec is the ``ell_matvec`` kernel.

The plan (``EllDirect``) is built on the host in numpy, as in the
reference; ``ell_device_plan`` validates it and puts the index tensors the
kernels read on the graph's device once per solve.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.core import FactorGraph
from . import lm as _lm
from .assemble import free_mask, linearize_batch
from .cuda_ops import ell_matvec, slot_reduce
from .linear import pcg_solve

# --------------------------------------------------------------------------
# Direct-to-ELL plan (numpy, as in the reference)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EllDirect:
    """Static direct-to-ELL assembly plan (diag at slot 0)."""

    nb: int
    d: int
    K: int
    cols: np.ndarray  # (nb, K) int32, cols[:,0] == arange(nb)
    valid: np.ndarray  # (nb, K)
    # per batch: list of (slot_a, slot_b, flat_pos_ab (F,), flat_pos_ba (F,))
    # where flat positions index (nb*K); for a==b only flat_pos_ab is used
    maps: tuple


def build_ell_direct(graph: FactorGraph, block_name: str | None = None) -> EllDirect:
    """Vectorized (no per-edge Python): the plan build is numpy
    sort/searchsorted.  Raises on a factor index outside the block, which
    the reference would clamp silently."""
    if block_name is None:
        (block_name,) = graph.blocks.keys()
    blk = graph.blocks[block_name]
    nb, d = blk.n, blk.dof

    # collect all directed off-diagonal edges across batches
    us, vs = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    batch_pairs = []
    for fb in graph.batches:
        if not all(s == block_name for s in fb.slots):
            raise ValueError(f"ELL path supports one variable block; batch {fb.kind!r} has slots {fb.slots}")
        idx = [i.detach().cpu().numpy().astype(np.int64) for i in fb.indices]
        for i in idx:
            if len(i) and (i.min() < 0 or i.max() >= nb):
                raise ValueError(
                    f"factor batch {fb.kind!r}: index out of range [0, {nb}) "
                    f"(min {i.min()}, max {i.max()})"
                )
        slot_pairs = []
        for a in range(len(idx)):
            for b in range(a, len(idx)):
                ia, ib = idx[a], idx[b]
                if a != b:
                    off = ia != ib
                    us.append(ia[off])
                    vs.append(ib[off])
                    us.append(ib[off])
                    vs.append(ia[off])
                slot_pairs.append((a, b, ia, ib))
        batch_pairs.append(slot_pairs)

    u = np.concatenate(us)
    v = np.concatenate(vs)
    keys = np.unique(u * nb + v)  # sorted unique directed edges
    eu, ev = keys // nb, keys % nb
    row_counts = np.bincount(eu, minlength=nb)
    K = 1 + int(row_counts.max()) if len(keys) else 1
    row_starts = np.concatenate([[0], np.cumsum(row_counts)[:-1]])
    rank = np.arange(len(keys)) - row_starts[eu]  # rank of edge within row
    edge_slot = eu * K + 1 + rank  # flat ELL position of each unique edge

    cols = np.tile(np.arange(nb, dtype=np.int32)[:, None], (1, K))
    valid = np.zeros((nb, K), np.float64)
    valid[:, 0] = 1.0
    cols[eu, 1 + rank] = ev.astype(np.int32)
    valid[eu, 1 + rank] = 1.0

    def lookup(uu, vv):
        """Flat ELL position of (uu, vv); diagonal maps to slot 0."""
        if len(keys) == 0:  # no off-diagonal edges at all: everything is
            return np.asarray(uu) * K  # diagonal (uu == vv by construction)
        pos = np.searchsorted(keys, uu * nb + vv)
        out = edge_slot[np.minimum(pos, len(keys) - 1)]
        return np.where(uu == vv, uu * K, out)

    maps = []
    for slot_pairs in batch_pairs:
        entries = []
        for a, b, ia, ib in slot_pairs:
            if a == b:
                entries.append((a, b, ia * K, None))
            else:
                entries.append((a, b, lookup(ia, ib), lookup(ib, ia)))
        maps.append(tuple(entries))
    return EllDirect(nb, d, K, cols, valid, tuple(maps))


# --------------------------------------------------------------------------
# Slot plans for the segmented reductions
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """Contributions sorted stably by destination: contribution ``perm[e]``
    is the e-th to add, and slot s sums ``[offsets[s], offsets[s+1])``."""

    perm: np.ndarray  # (E,) int32
    offsets: np.ndarray  # (n_slots + 1,) int32
    n_slots: int


def slot_plan(dest: np.ndarray, n_slots: int) -> SlotPlan:
    dest = np.asarray(dest, np.int64)
    if len(dest) and (dest.min() < 0 or dest.max() >= n_slots):
        raise ValueError(f"slot destination out of range [0, {n_slots})")
    if len(dest) >= 2**31:
        raise ValueError("too many contributions for int32 offsets")
    perm = np.argsort(dest, kind="stable").astype(np.int32)
    counts = np.bincount(dest, minlength=n_slots)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return SlotPlan(perm, offsets, n_slots)


def build_slot_plans(plan: EllDirect) -> tuple[SlotPlan, SlotPlan]:
    """(Hessian plan over nb*K ELL slots, gradient plan over nb poses).

    The contribution order is the one ``assemble_ell`` stacks: over the
    batches, for each entry (a, b) of ``plan.maps``, the F blocks C_ab to
    ``pos_ab`` and then, for a != b, the F blocks C_abᵀ to ``pos_ba``; and
    for the gradient, each slot's F rows to its poses (a slot's poses are
    its diagonal entry's positions divided by K)."""
    h_dest, g_dest = [], []
    for entries in plan.maps:
        for a, b, pos_ab, pos_ba in entries:
            h_dest.append(pos_ab)
            if pos_ba is not None:
                h_dest.append(pos_ba)
            if a == b:
                g_dest.append(np.asarray(pos_ab) // plan.K)
    empty = np.zeros(0, np.int64)
    return (
        slot_plan(np.concatenate(h_dest) if h_dest else empty, plan.nb * plan.K),
        slot_plan(np.concatenate(g_dest) if g_dest else empty, plan.nb),
    )


@dataclasses.dataclass(frozen=True)
class EllDevicePlan:
    """An ``EllDirect`` with the index tensors its kernels read, on one
    device: ELL columns and both slot plans, int32."""

    host: EllDirect
    cols: torch.Tensor  # (nb, K) int32
    h_perm: torch.Tensor
    h_offsets: torch.Tensor
    g_perm: torch.Tensor
    g_offsets: torch.Tensor


def ell_device_plan(plan: EllDirect, device) -> EllDevicePlan:
    if plan.cols.shape != (plan.nb, plan.K) or (
        plan.cols.size and (plan.cols.min() < 0 or plan.cols.max() >= plan.nb)
    ):
        raise ValueError(f"plan.cols must be ({plan.nb}, {plan.K}) with entries in [0, {plan.nb})")
    hp, gp = build_slot_plans(plan)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)

    return EllDevicePlan(plan, t(plan.cols), t(hp.perm), t(hp.offsets), t(gp.perm), t(gp.offsets))


# --------------------------------------------------------------------------
# Assembly
# --------------------------------------------------------------------------


def ell_contributions(graph: FactorGraph, plan: EllDirect):
    """Linearize every batch: (Hessian contributions (E_h, d*d), gradient
    contributions J^T W r (E_g, d), chi2), stacked in the order of
    ``build_slot_plans``."""
    d = plan.d
    dtype = next(iter(graph.blocks.values())).values.dtype
    device = next(iter(graph.blocks.values())).values.device
    chi2 = torch.zeros((), dtype=dtype, device=device)
    h_parts, g_parts = [], []
    for fb, entries in zip(graph.batches, plan.maps):
        r, jacs, w, c2 = linearize_batch(fb, graph.blocks)
        chi2 = chi2 + c2
        wr = w * r
        for J in jacs:
            g_parts.append((J.transpose(1, 2) @ wr[..., None])[..., 0])  # (F, d)
        for a, b, pos_ab, pos_ba in entries:
            C = jacs[a].transpose(1, 2) @ (w[..., None] * jacs[b])  # (F, d, d)
            h_parts.append(C.reshape(-1, d * d))
            if pos_ba is not None:
                h_parts.append(C.transpose(1, 2).reshape(-1, d * d))
    return torch.cat(h_parts).contiguous(), torch.cat(g_parts).contiguous(), chi2


def assemble_ell(graph: FactorGraph, dplan: EllDevicePlan):
    """(He (nb, K, d, d), g (nb*d,), chi2) straight from the factor batches."""
    plan = dplan.host
    nb, d, K = plan.nb, plan.d, plan.K
    dtype = next(iter(graph.blocks.values())).values.dtype
    h_contrib, g_contrib, chi2 = ell_contributions(graph, plan)
    He = slot_reduce(h_contrib, dplan.h_perm, dplan.h_offsets, nb * K).reshape(nb, K, d, d)
    g = -slot_reduce(g_contrib, dplan.g_perm, dplan.g_offsets, nb).reshape(-1)

    # constant parameters: zero rows/cols, unit diagonal at slot 0
    free = free_mask(graph).to(dtype).reshape(nb, d)
    He = He * free[:, None, :, None] * free[dplan.cols][:, :, None, :]
    eye = torch.eye(d, dtype=dtype, device=He.device)
    He[:, 0] += (1.0 - free)[:, :, None] * eye
    g = g * free.reshape(-1)
    return He, g, chi2


# --------------------------------------------------------------------------
# Block-Jacobi preconditioner
# --------------------------------------------------------------------------


def _inv33(A):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d_, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g_, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g_ - d_ * i
    co11 = a * i - c * g_
    co12 = c * d_ - a * f
    co20 = d_ * h - e * g_
    co21 = b * g_ - a * h
    co22 = a * e - b * d_
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / det
    rows = [
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co10, co11, co12], dim=-1),
        torch.stack([co20, co21, co22], dim=-1),
    ]
    return torch.stack(rows, dim=-2) * inv_det[..., None, None]


def sym_block_inv(D):
    """Batched closed-form inverse of small SPD blocks: adjugate for d<=3,
    blocked 3x3 Schur complement for d=6, Cholesky otherwise (NaN blocks
    where the factorization fails, as the reference's Cholesky gives)."""
    d = D.shape[-1]
    if d == 1:
        return 1.0 / D
    if d == 2:
        a, b = D[..., 0, 0], D[..., 0, 1]
        c, e = D[..., 1, 0], D[..., 1, 1]
        det = a * e - b * c
        inv = torch.stack([torch.stack([e, -b], -1), torch.stack([-c, a], -1)], dim=-2)
        return inv / det[..., None, None]
    if d == 3:
        return _inv33(D)
    if d == 6:
        A = D[..., :3, :3]
        B = D[..., :3, 3:]
        Cm = D[..., 3:, 3:]
        Ai = _inv33(A)
        AiB = Ai @ B
        S = Cm - B.transpose(-1, -2) @ AiB
        Si = _inv33(S)
        TL = Ai + AiB @ Si @ AiB.transpose(-1, -2)
        TR = -(AiB @ Si)
        BL = TR.transpose(-1, -2)
        top = torch.cat([TL, TR], dim=-1)
        bot = torch.cat([BL, Si], dim=-1)
        return torch.cat([top, bot], dim=-2)
    # generic fallback
    L, info = torch.linalg.cholesky_ex(D)
    eye = torch.eye(d, dtype=D.dtype, device=D.device).expand(D.shape)
    Y = torch.linalg.solve_triangular(L, eye, upper=False)
    inv = torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)
    return torch.where((info != 0)[..., None, None], float("nan"), inv)


# --------------------------------------------------------------------------
# Solve
# --------------------------------------------------------------------------


def solve_ell(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    plan: EllDirect | None = None,
    pcg_rtol: float | None = None,
    pcg_max_iters: int | None = None,
    precond: str = "bj",
    coarse_size: int = 128,
):
    """GN/LM with direct-to-ELL assembly, slice damping and closed-form
    block-Jacobi PCG.  Returns (solved_graph, SolveInfo).

    CG budget defaults are size-adaptive, as in the reference: rtol 3e-6 /
    at least 120 iterations up to 10k poses, rtol 1e-8 beyond, and
    ``max(120, nb // 80)`` iterations capped at 1000.  Explicit arguments
    override.  ``precond="two_level"`` (and its ``coarse_size``) is not
    ported yet and raises NotImplementedError."""
    if precond != "bj":
        raise NotImplementedError(f"precond={precond!r} is not ported yet (only 'bj')")
    if plan is None:
        plan = build_ell_direct(graph)
    if pcg_rtol is None:
        pcg_rtol = 3e-6 if plan.nb <= 10_000 else 1e-8
    if pcg_max_iters is None:
        pcg_max_iters = min(1000, max(120, plan.nb // 80))
    nb, d = plan.nb, plan.d
    device = next(iter(graph.blocks.values())).values.device
    dplan = ell_device_plan(plan, device)

    def assemble_fn(g):
        return assemble_ell(g, dplan)

    def matvec_fn(He, x):
        return ell_matvec(He, dplan.cols, x)

    def solve_fn(He, g, lam, opt):
        D = He[:, 0]
        if opt.method == "lm":
            diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=1e-12)
            D = D + lam * torch.diag_embed(diag)
            He_d = He.clone()
            He_d[:, 0] = D
        else:
            He_d = He
        Minv = sym_block_inv(D)

        def precond_fn(r):
            return (Minv @ r.reshape(nb, d, 1)).reshape(-1)

        dx, _ = pcg_solve(
            lambda x: matvec_fn(He_d, x), g, precond=precond_fn, rtol=pcg_rtol,
            max_iters=pcg_max_iters,
        )
        return dx

    return _lm.solve(
        graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn, matvec_fn=matvec_fn
    )
