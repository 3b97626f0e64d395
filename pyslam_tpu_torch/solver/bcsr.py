"""Direct-to-ELL normal equations + block-Jacobi PCG for large pose graphs.

Counterpart of the ``solve_ell`` path of ``pyslam_tpu/solver/bcsr.py``.
The Hessian is stored in a symmetric ELL layout, He (nb, K, d, d): for each
pose r, K neighbour blocks with the diagonal block pinned at slot 0, so
that Marquardt damping and the block-Jacobi preconditioner read He[:, 0]
as a slice.

Per LM iteration:
  * assembly (``assemble_ell``).  An SE(3) pose graph (``between_se3`` /
    ``prior_se3`` batches on one block, an elementwise loss) is assembled by
    the ``ell_assemble`` kernel: linearization, the ordered sums into the
    ELL slots, masks, gradient and chi2 in two launches.  Any other graph
    takes the general route: factor linearization in plain tensor code, then
    two calls of the ``slot_reduce`` kernel — one reduces every factor's
    JᵀWJ blocks into their ELL slots, one reduces the gradient rows into
    their poses.  Which route is a property of the graph alone
    (``ell_assemble_batches``).  The order of each reduction is fixed by a
    plan sorted once on the host (``SlotPlan``), so the result does not
    change from run to run;
  * Marquardt damping of the slot-0 blocks and the closed-form 6×6
    block-Jacobi inverse (``sym_block_inv``), plain tensor code;
  * PCG: the ``ell_pcg`` kernel, one launch per linear solve (on CPU
    tensors ``linear.pcg_solve`` over the plain product).  Dogleg's model
    products go through the ``ell_matvec`` kernel.

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
from .assemble import dense_contributions, free_mask
from .cuda_ops import (
    MAX_ASSEMBLE_BATCHES,
    AssembleBatch,
    SlotPlan,
    ell_assemble,
    ell_matvec,
    ell_pcg,
    kernel_loss,
    slot_plan,
    slot_reduce,
)

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


def build_assemble_tables(plan: EllDirect, h_plan: SlotPlan):
    """The tables the ``ell_assemble`` kernel reads beside the Hessian slot
    plan, or None where a batch has other than one or two slots:

    * ``idx`` (F_total, 2) int32: the poses of every factor, the batches one
      after the other (a one-slot factor names its pose twice);
    * ``entries`` (E,) int32: for every position of ``h_plan`` the
      contribution it adds, packed as ``factor << 3 | a << 2 | b << 1 | t``:
      the block J_aᵀ W J_b of that factor, transposed where t = 1.  The
      contributions are numbered as ``build_slot_plans`` stacks them, so the
      kernel sums every slot in the order ``slot_reduce`` does;
    * ``first``: each batch's first factor, then F_total."""
    idx, codes, first = [], [], [0]
    for entries in plan.maps:
        slots = {a: np.asarray(pos_ab, np.int64) // plan.K for a, b, pos_ab, _ in entries if a == b}
        if sorted(slots) not in ([0], [0, 1]):
            return None
        factor = first[-1] + np.arange(len(slots[0]), dtype=np.int64)
        idx.append(np.stack([slots[0], slots[len(slots) - 1]], axis=1))
        for a, b, _, pos_ba in entries:
            codes.append(factor << 3 | a << 2 | b << 1)
            if pos_ba is not None:
                codes.append(factor << 3 | a << 2 | b << 1 | 1)
        first.append(first[-1] + len(factor))
    if first[-1] >= 2**28:
        raise ValueError("too many factors for the packed int32 entries")
    codes = np.concatenate(codes) if codes else np.zeros(0, np.int64)
    if len(codes) != len(h_plan.perm):
        raise ValueError(f"{len(codes)} contributions for a slot plan of {len(h_plan.perm)}")
    idx = np.concatenate(idx) if idx else np.zeros((0, 2), np.int64)
    return idx.astype(np.int32), codes[h_plan.perm].astype(np.int32), tuple(first)


@dataclasses.dataclass(frozen=True)
class EllDevicePlan:
    """An ``EllDirect`` with the index tensors its kernels read, on one
    device: ELL columns, both slot plans and the ``ell_assemble`` tables
    (``build_assemble_tables``; None where they do not apply), int32."""

    host: EllDirect
    cols: torch.Tensor  # (nb, K) int32
    h_perm: torch.Tensor
    h_offsets: torch.Tensor
    g_perm: torch.Tensor
    g_offsets: torch.Tensor
    a_idx: torch.Tensor | None = None  # (F_total, 2)
    a_entries: torch.Tensor | None = None  # (E,), segments h_offsets
    a_first: tuple | None = None


def ell_device_plan(plan: EllDirect, device) -> EllDevicePlan:
    if plan.cols.shape != (plan.nb, plan.K) or (
        plan.cols.size and (plan.cols.min() < 0 or plan.cols.max() >= plan.nb)
    ):
        raise ValueError(f"plan.cols must be ({plan.nb}, {plan.K}) with entries in [0, {plan.nb})")
    hp, gp = build_slot_plans(plan)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)

    tables = build_assemble_tables(plan, hp)
    a_idx, a_entries, a_first = (t(tables[0]), t(tables[1]), tables[2]) if tables else (None, None, None)
    return EllDevicePlan(
        plan, t(plan.cols), t(hp.perm), t(hp.offsets), t(gp.perm), t(gp.offsets), a_idx, a_entries, a_first
    )


# --------------------------------------------------------------------------
# Assembly
# --------------------------------------------------------------------------


def ell_contributions(graph: FactorGraph, plan: EllDirect):
    """Linearize every batch: (Hessian contributions (E_h, d*d), gradient
    contributions J^T W r (E_g, d), chi2), stacked in the order of
    ``build_slot_plans``: with one block kind, the one (d, d) group of the
    dense assembly's contributions."""
    d = plan.d
    h_parts, g_parts, chi2 = dense_contributions(graph, hessian=True)
    return torch.cat(h_parts[(d, d)]).contiguous(), torch.cat(g_parts[(d,)]).contiguous(), chi2


_ASSEMBLE_KINDS = {"between_se3": 2, "prior_se3": 1}


def ell_assemble_batches(graph: FactorGraph):
    """The graph's batches as the ``ell_assemble`` kernel takes them, or None
    for a graph it does not take.  It takes a graph of one ``se3`` block
    whose batches, ``MAX_ASSEMBLE_BATCHES`` at most, are all ``between_se3``
    or ``prior_se3`` with a loss that ``kernel_loss`` knows (every loss of
    ``losses.py`` but ``TDistributionLoss(scale=None)``) and a ``sqrt_info``
    that carries the factor axis.  The answer depends on the graph only,
    not on where its tensors lie."""
    if len(graph.blocks) != 1 or len(graph.batches) > MAX_ASSEMBLE_BATCHES:
        return None
    ((name, block),) = graph.blocks.items()
    if block.kind != "se3":
        return None
    out = []
    for fb in graph.batches:
        n_slots = _ASSEMBLE_KINDS.get(fb.kind)
        if n_slots is None or fb.slots != (name,) * n_slots or kernel_loss(fb.loss) is None:
            return None
        if fb.data["sqrt_info"].dim() != 3:  # one matrix for the whole batch: the kernel reads one a factor
            return None
        out.append(AssembleBatch(n_slots, fb.data["T_obs"], fb.data["sqrt_info"], fb.weight, fb.loss))
    return out


def assemble_ell(graph: FactorGraph, dplan: EllDevicePlan):
    """(He (nb, K, d, d), g (nb*d,), chi2) straight from the factor batches:
    through ``ell_assemble`` for the graphs ``ell_assemble_batches`` takes,
    else ``ell_contributions`` and two ``slot_reduce``."""
    batches = ell_assemble_batches(graph)
    if batches is not None and dplan.a_entries is not None:
        block = next(iter(graph.blocks.values()))
        return ell_assemble(
            block.values, block.const_mask, batches, dplan.cols, dplan.a_idx, dplan.a_entries,
            dplan.h_offsets, dplan.a_first,
        )
    return assemble_ell_general(graph, dplan)


def assemble_ell_general(graph: FactorGraph, dplan: EllDevicePlan):
    """``assemble_ell`` for any one-block graph: linearization in plain
    tensor code, two ``slot_reduce`` calls, then the masks."""
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
        return ell_pcg(He_d, dplan.cols, Minv.contiguous(), g, pcg_rtol, pcg_max_iters).x

    return _lm.solve(
        graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn, matvec_fn=matvec_fn
    )
