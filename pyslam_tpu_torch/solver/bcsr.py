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

``precond="two_level"`` adds to block-Jacobi a coarse correction over BFS
groups of poses (``_coarse_groups``): A_c = PᵀAP is one ``slot_reduce`` of
the damped ELL blocks into the coarse blocks that receive any, factored
once a linear solve; r_c is one ``slot_reduce`` by group an application.
``ell_pcg`` fuses only block-Jacobi, so this PCG is ``schur_large._pcg``
(no host read, no breakdown guard: ``linear.pcg_solve``'s iterates) around
``cuda_ops.ell_matvec``; ``schur_large.cg_iterations`` reads its counts.

The BCSR family (``BlockPattern``, ``build_pattern``, ``assemble_bcsr``,
``bcsr_matvec``, ``block_jacobi_inv``, ``damp_blocks``, ``EllPattern``,
``build_ell``, ``ell_blocks``, ``ell_matvec``, ``GroupJacobi``,
``build_group_jacobi``, ``group_jacobi_factor``, ``group_jacobi_apply``,
``solve_bcsr``): the Hessian over the upper block pattern, diagonal
included.  The patterns are the reference's arrays, built by numpy sorts
in place of its per-pair Python loops.  Assembly is the linearization and
one ``slot_reduce`` of the blocks into the upper store (and one of the
gradient rows into their poses); the upper-store product is two
``slot_reduce`` passes, by rows and by columns; the ELL expansion of the
damped store multiplies through ``cuda_ops.ell_matvec``.  Each pattern's
device plans are built once and kept by content (``bcsr_device_plan``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.core import FactorGraph
from ..observability import span
from . import lm as _lm
from .assemble import dense_contributions, free_mask, linearize_batch
from .plan_cache import ClosureCache, content_key
from .schur import Segments, _binv, _cholesky, _jtwj, _mv, _tmv
from .schur_large import _CG_ITERATIONS, _pcg, _segments
from . import cuda_ops
from .cuda_ops import (
    MAX_ASSEMBLE_BATCHES,
    AssembleBatch,
    SlotPlan,
    ell_assemble,
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


@span("plan")
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
    """The tables the ``ell_assemble`` kernel reads beside the ELL columns,
    or None where a batch has other than one or two slots:

    * ``idx`` (F_total, 2) int32: the poses of every factor, the batches one
      after the other (a one-slot factor names its pose twice);
    * ``entries`` (E, 2) int32, by pose row r: every contribution to r's
      diagonal slot in the order ``h_plan`` sums it, packed as ``factor << 3
      | a << 2 | b << 1 | t`` (the block J_aᵀ W J_b of that factor,
      transposed where t = 1), beside the slot k of row r that the same
      factor's off-diagonal block goes to (where a == b names a two-slot
      factor whose other pose is another; else 0).  The contributions are
      numbered as ``build_slot_plans`` stacks them; an off-diagonal slot's
      are those of its row's entries that name it, in the row's order, which
      is the order ``h_plan`` sums that slot (a factor adds its blocks to
      its two diagonal slots in the same sequence as to the pair's slots);
    * ``rows`` (nb + 1,) int32: the segments of ``entries`` by row;
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
    by_slot = codes[h_plan.perm]
    slot = np.repeat(np.arange(plan.nb * plan.K), np.diff(h_plan.offsets))
    diagonal = slot % plan.K == 0
    # the off-diagonal slot of each (factor, t): a pair's block goes to row
    # idx[factor, t], the transposed one (t = 1) to the second pose's row
    k_of = np.zeros(2 * first[-1], np.int64)
    k_of[(by_slot[~diagonal] >> 3) * 2 + (by_slot[~diagonal] & 1)] = slot[~diagonal] % plan.K
    diag = by_slot[diagonal]
    a = (diag >> 2) & 1
    k = np.where(a == ((diag >> 1) & 1), k_of[(diag >> 3) * 2 + a], 0)
    rows = np.concatenate([[0], np.cumsum(np.diff(h_plan.offsets)[:: plan.K])])
    return idx.astype(np.int32), np.stack([diag, k], axis=1).astype(np.int32), rows.astype(np.int32), tuple(first)


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
    a_entries: torch.Tensor | None = None  # (E, 2), segments a_rows
    a_rows: torch.Tensor | None = None  # (nb + 1,)
    a_first: tuple | None = None
    h_longest: int | None = None  # the slot plans' longest segments (``slot_reduce``'s ``longest``)
    g_longest: int | None = None


def ell_device_plan(plan: EllDirect, device) -> EllDevicePlan:
    if plan.cols.shape != (plan.nb, plan.K) or (
        plan.cols.size and (plan.cols.min() < 0 or plan.cols.max() >= plan.nb)
    ):
        raise ValueError(f"plan.cols must be ({plan.nb}, {plan.K}) with entries in [0, {plan.nb})")
    hp, gp = build_slot_plans(plan)

    def t(a):
        a = np.ascontiguousarray(a, np.int32)
        with span("read"):  # a copy from pageable host memory waits for the device
            return torch.as_tensor(a, device=device)

    tables = build_assemble_tables(plan, hp)
    a_idx, a_entries, a_rows = (t(x) for x in tables[:3]) if tables else (None, None, None)
    return EllDevicePlan(
        plan, t(plan.cols), t(hp.perm), t(hp.offsets), t(gp.perm), t(gp.offsets), a_idx, a_entries, a_rows,
        tables[3] if tables else None, hp.longest, gp.longest,
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


def ell_assemble_args(graph: FactorGraph, dplan: EllDevicePlan):
    """The arguments of ``ell_assemble`` for ``graph`` on ``dplan``, or None
    where the kernel does not take the graph."""
    batches = ell_assemble_batches(graph)
    if batches is None or dplan.a_entries is None:
        return None
    block = next(iter(graph.blocks.values()))
    return (block.values, block.const_mask, batches, dplan.cols, dplan.a_idx, dplan.a_entries, dplan.a_rows,
            dplan.a_first)


def assemble_ell(graph: FactorGraph, dplan: EllDevicePlan):
    """(He (nb, K, d, d), g (nb*d,), chi2) straight from the factor batches:
    through ``ell_assemble`` for the graphs ``ell_assemble_batches`` takes,
    else ``ell_contributions`` and two ``slot_reduce``."""
    args = ell_assemble_args(graph, dplan)
    return assemble_ell_general(graph, dplan) if args is None else ell_assemble(*args)


def assemble_ell_general(graph: FactorGraph, dplan: EllDevicePlan):
    """``assemble_ell`` for any one-block graph: linearization in plain
    tensor code, two ``slot_reduce`` calls, then the masks."""
    plan = dplan.host
    nb, d, K = plan.nb, plan.d, plan.K
    dtype = next(iter(graph.blocks.values())).values.dtype
    h_contrib, g_contrib, chi2 = ell_contributions(graph, plan)
    He = slot_reduce(h_contrib, dplan.h_perm, dplan.h_offsets, nb * K, dplan.h_longest).reshape(nb, K, d, d)
    g = -slot_reduce(g_contrib, dplan.g_perm, dplan.g_offsets, nb, dplan.g_longest).reshape(-1)

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


@span("solve")
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
    override.

    ``precond``: ``"bj"`` (per-pose block-Jacobi, the ``ell_pcg`` kernel)
    or ``"two_level"`` (additive two-level Schwarz: block-Jacobi plus a
    coarse correction over ~``coarse_size``-pose BFS groups, A_c = PᵀAP with
    piecewise-constant prolongation, dense-factored once a linear solve;
    PCG by ``schur_large._pcg``, its products ``ell_matvec``).  The
    reference takes any other name for ``"bj"``; here it raises.

    Spans (``observability.span``): ``solve`` around the call,
    ``ell.device_plan``, and ``ell.assemble`` / ``ell.linear_solve`` around
    each assembly and linear solve ``lm.solve`` asks for."""
    if precond not in ("bj", "two_level"):
        raise ValueError(f"precond must be 'bj' or 'two_level', got {precond!r}")
    if plan is None:
        plan = build_ell_direct(graph)
    if pcg_rtol is None:
        pcg_rtol = 3e-6 if plan.nb <= 10_000 else 1e-8
    if pcg_max_iters is None:
        pcg_max_iters = min(1000, max(120, plan.nb // 80))
    device = next(iter(graph.blocks.values())).values.device
    with span("ell.device_plan"):
        dplan = ell_device_plan(plan, device)
    coarse = _coarse_plan(graph, plan, coarse_size, device) if precond == "two_level" else None

    @span("ell.assemble")
    def assemble_fn(g):
        return assemble_ell(g, dplan)

    def matvec_fn(He, x):
        return cuda_ops.ell_matvec(He, dplan.cols, x)

    @span("ell.linear_solve")
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
        if coarse is None:
            return ell_pcg(He_d, dplan.cols, Minv.contiguous(), g, pcg_rtol, pcg_max_iters).x
        return _two_level_pcg(He_d, Minv, g, dplan, coarse, pcg_rtol, pcg_max_iters)

    return _lm.solve(
        graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn, matvec_fn=matvec_fn
    )


# --------------------------------------------------------------------------
# Two-level preconditioner (precond="two_level")
# --------------------------------------------------------------------------

def _coarse_groups(graph: FactorGraph, plan: EllDirect, coarse_size: int):
    """(group (nb,), G): BFS aggregation of poses into ~coarse_size groups
    for the two-level preconditioner (the partitioner of ``dist/``)."""
    from ..dist.partitioner import partition_poses_bfs

    nb = plan.nb
    valid = plan.valid[:, 1:] > 0
    eu = np.repeat(np.arange(nb, dtype=np.int64), valid.sum(axis=1))
    ev = plan.cols[:, 1:][valid].astype(np.int64)
    und = eu < ev
    G = max(1, -(-nb // coarse_size))
    part = partition_poses_bfs(eu[und], ev[und], nb, G)
    return part.part.astype(np.int32), G


@dataclasses.dataclass(frozen=True)
class CoarsePlan:
    """The two-level preconditioner's tables on one device: each pose's
    group, the plan of A_c = PᵀAP (every ELL block of the nb*K store to the
    coarse block (group(r), group(cols[r, k])), planned over the U coarse
    blocks that receive any, ``blocks`` their flat index in G*G) and the
    plan of r_c (each pose's row to its group)."""

    G: int
    group: torch.Tensor  # (nb,) int64
    blocks: torch.Tensor  # (U,) int64
    to_coarse: Segments  # nb*K -> U
    by_group: Segments  # nb -> G


def _coarse_plan(graph, plan: EllDirect, coarse_size: int, device) -> CoarsePlan:
    group, G = _coarse_groups(graph, plan, coarse_size)
    group = group.astype(np.int64)
    flat = (group[:, None] * G + group[plan.cols]).reshape(-1)
    uniq, dest = np.unique(flat, return_inverse=True)
    return CoarsePlan(G, torch.as_tensor(group, device=device), torch.as_tensor(uniq, device=device),
                      _segments(dest.reshape(-1), len(uniq), device), _segments(group, G, device))


def _two_level_pcg(He_d, Minv, g, dplan: EllDevicePlan, coarse: CoarsePlan, rtol, max_iters):
    """PCG under block-Jacobi plus the coarse correction: A_c by one
    ``slot_reduce`` of the damped blocks (padding slots hold zero blocks),
    its Cholesky (NaN where it fails), then ``schur_large._pcg`` whose
    products are ``ell_matvec`` and whose r_c is one ``slot_reduce``."""
    nb, K, d, _ = He_d.shape
    G = coarse.G
    Ac = He_d.new_zeros((G * G, d * d))
    Ac[coarse.blocks] = coarse.to_coarse.sum(He_d.reshape(nb * K, d * d))
    L = _cholesky(Ac.reshape(G, G, d, d).transpose(1, 2).reshape(G * d, G * d))

    def precond(r):
        rb = r.reshape(nb, d)
        rc = coarse.by_group.sum(rb).reshape(G * d, 1)
        y = torch.linalg.solve_triangular(L, rc, upper=False)
        xc = torch.linalg.solve_triangular(L.transpose(0, 1), y, upper=True).reshape(G, d)
        return (_mv(Minv, rb) + xc[coarse.group]).reshape(-1)

    x, it = _pcg(lambda v: cuda_ops.ell_matvec(He_d, dplan.cols, v), precond, g, rtol, max_iters, read_every=0,
                 guard=False)
    _CG_ITERATIONS.append(it)
    return x


# --------------------------------------------------------------------------
# The BCSR family: upper block store over a static pattern
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockPattern:
    """Host-side static BCSR pattern for a single-block pose graph.

    rows/cols: (nnzb,) upper-triangular block coordinates (row <= col),
    lexicographically sorted, diagonal blocks first-class members.
    maps: per batch, a list of (slot_a, slot_b, pair_pos (F,), transpose (F,))
    entries steering each factor's block contribution to its pattern slot.
    """

    block_name: str
    nb: int
    d: int
    rows: np.ndarray
    cols: np.ndarray
    diag_pos: np.ndarray  # (nb,) position of each diagonal block
    maps: tuple  # per batch: tuple of (a, b, pos (F,), transpose (F,))

    @property
    def nnzb(self) -> int:
        return len(self.rows)


def build_pattern(graph: FactorGraph, block_name: str | None = None) -> BlockPattern:
    """Derive the static block-sparsity pattern from the factor indices: the
    reference's arrays, by one numpy sort of the pair keys.  Raises on a
    graph of more than one variable block and on a factor index outside the
    block (the reference asserts the first and clamps the second)."""
    if block_name is None:
        (block_name,) = graph.blocks.keys()
    blk = graph.blocks[block_name]
    nb, d = blk.n, blk.dof

    keys = [np.arange(nb, dtype=np.int64) * (nb + 1)]
    batch_pairs = []
    for fb in graph.batches:
        if not all(s == block_name for s in fb.slots):
            raise ValueError("BCSR path supports a single variable block; use the Schur path for camera+landmark "
                             "problems")
        idx = [i.detach().cpu().numpy().astype(np.int64) for i in fb.indices]
        for i in idx:
            if len(i) and (i.min() < 0 or i.max() >= nb):
                raise ValueError(f"factor batch {fb.kind!r}: index out of range [0, {nb}) "
                                 f"(min {i.min()}, max {i.max()})")
        slot_pairs = []
        for a in range(len(idx)):
            for b in range(a, len(idx)):
                ia, ib = idx[a], idx[b]
                keys.append(np.minimum(ia, ib) * nb + np.maximum(ia, ib))
                slot_pairs.append((a, b, ia, ib))
        batch_pairs.append(slot_pairs)

    uniq = np.unique(np.concatenate(keys))
    rows, cols = uniq // nb, uniq % nb
    diag_pos = np.searchsorted(uniq, np.arange(nb, dtype=np.int64) * (nb + 1)).astype(np.int32)
    maps = tuple(
        tuple((a, b, np.searchsorted(uniq, np.minimum(ia, ib) * nb + np.maximum(ia, ib)).astype(np.int32), ia > ib)
              for a, b, ia, ib in slot_pairs)
        for slot_pairs in batch_pairs)
    return BlockPattern(block_name, nb, d, rows.astype(np.int32), cols.astype(np.int32), diag_pos, maps)


@dataclasses.dataclass(frozen=True)
class BcsrDevicePlan:
    """A ``BlockPattern``'s tables on one device: the ``slot_reduce`` plans
    of the assembly (every contribution in ``assemble_bcsr``'s stacking
    order to its pattern slot; every gradient row to its pose) and of the
    two product passes (the stored blocks by row; the strictly-upper ones,
    transposed, by column)."""

    rows: torch.Tensor  # (nnzb,) int64
    cols: torch.Tensor
    diag_pos: torch.Tensor  # (nb,) int64
    transpose: torch.Tensor  # (E,) bool, per contribution in stacking order
    to_slot: Segments  # E contributions -> nnzb
    to_pose: Segments  # gradient rows -> nb
    upper: torch.Tensor  # (nnzu,) int64, the strictly-upper positions
    by_row: Segments  # nnzb -> nb
    by_col: Segments  # nnzu -> nb


_DEVICE_PLANS = ClosureCache()


def bcsr_device_plan(pattern: BlockPattern, device) -> BcsrDevicePlan:
    """The device tables of ``pattern``, built once for its content and
    ``device``."""
    device = torch.device(device)
    key = (content_key(pattern), str(device))
    if key not in _DEVICE_PLANS:
        nb = pattern.nb
        pos = [p.astype(np.int64) for entries in pattern.maps for (_, _, p, _) in entries]
        trans = [t for entries in pattern.maps for (_, _, _, t) in entries]
        g_dest = []
        for entries in pattern.maps:
            for a, b, p, t in entries:
                if a == b:  # the slot's own diagonal position names its pose
                    g_dest.append(pattern.rows[p].astype(np.int64))
        empty = np.zeros(0, np.int64)

        def cat(a):
            return np.concatenate(a) if a else empty

        upper = np.flatnonzero(pattern.rows != pattern.cols)

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        _DEVICE_PLANS[key] = BcsrDevicePlan(
            rows=t(pattern.rows), cols=t(pattern.cols), diag_pos=t(pattern.diag_pos),
            transpose=t(cat(trans).astype(bool), torch.bool), to_slot=_segments(cat(pos), pattern.nnzb, device),
            to_pose=_segments(cat(g_dest), nb, device), upper=t(upper),
            by_row=_segments(pattern.rows.astype(np.int64), nb, device),
            by_col=_segments(pattern.cols[upper].astype(np.int64), nb, device),
        )
    return _DEVICE_PLANS[key]


def assemble_bcsr(graph: FactorGraph, pattern: BlockPattern):
    """(H_blocks (nnzb, d, d), g (nb*d,), chi2): the linearization, then one
    ``slot_reduce`` of every JᵀWJ block (transposed where it lands below
    the diagonal) into the upper store and one of the gradient rows into
    their poses; constant poses masked as in the reference."""
    nb, d = pattern.nb, pattern.d
    values = graph.blocks[pattern.block_name].values
    dtype, device = values.dtype, values.device
    dp = bcsr_device_plan(pattern, device)
    chi2 = torch.zeros((), dtype=dtype, device=device)
    h_parts, g_parts = [], []
    for fb, entries in zip(graph.batches, pattern.maps):
        r, jacs, w, c2 = linearize_batch(fb, graph.blocks)
        chi2 = chi2 + c2
        wr = w * r
        for a, b, _, _ in entries:
            h_parts.append(_jtwj(jacs[a], w, jacs[b]))
            if a == b:
                g_parts.append(_tmv(jacs[a], wr))
    if h_parts:
        C = torch.cat(h_parts)
        C = torch.where(dp.transpose[:, None, None], C.transpose(-1, -2), C)
        H = dp.to_slot.sum(C)
        g = -dp.to_pose.sum(torch.cat(g_parts)).reshape(-1)
    else:
        H = torch.zeros((pattern.nnzb, d, d), dtype=dtype, device=device)
        g = torch.zeros(nb * d, dtype=dtype, device=device)

    # constant parameters: zero their rows/cols, unit diagonal on frozen dofs
    free = free_mask(graph).to(dtype).reshape(nb, d)
    H = H * free[dp.rows][:, :, None] * free[dp.cols][:, None, :]
    eye = torch.eye(d, dtype=dtype, device=device)
    H[dp.diag_pos] += (1.0 - free)[:, :, None] * eye
    return H, g * free.reshape(-1), chi2


def bcsr_matvec(H, pattern: BlockPattern, x):
    """y = H x with upper-block storage: one ``slot_reduce`` pass of the
    stored blocks by row, one of the strictly-upper blocks, transposed, by
    column."""
    nb, d = pattern.nb, pattern.d
    dp = bcsr_device_plan(pattern, H.device)
    xb = x.reshape(nb, d)
    y = dp.by_row.sum(_mv(H, xb[dp.cols]))
    y = y + dp.by_col.sum(_tmv(H[dp.upper], xb[dp.rows[dp.upper]]))
    return y.reshape(-1)


def block_jacobi_inv(H, pattern: BlockPattern):
    """Inverse diagonal blocks for the preconditioner, via batched Cholesky +
    triangular solves (NaN blocks where one is not positive definite)."""
    return _binv(_cholesky(H[bcsr_device_plan(pattern, H.device).diag_pos]))


def damp_blocks(H, pattern: BlockPattern, lam, floor=1e-12):
    """Marquardt damping on the diagonal blocks: H_ii += lam * diag(H_ii).
    Returns a new store."""
    at = bcsr_device_plan(pattern, H.device).diag_pos
    D = H[at]
    diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=floor)
    H = H.clone()
    H[at] = D + lam * torch.diag_embed(diag)
    return H


@dataclasses.dataclass(frozen=True)
class EllPattern:
    """Static symmetric ELL expansion of a BlockPattern.

    For each block-row r: K slots; slot k reads stored block ``sel[r,k]``
    (transposed when ``trans[r,k]``), multiplies x[cols[r,k]].  Padding slots
    point at block 0 with weight 0."""

    nb: int
    d: int
    K: int
    cols: np.ndarray  # (nb, K) int32
    sel: np.ndarray  # (nb, K) int32 into the BCSR block store
    trans: np.ndarray  # (nb, K) bool
    valid: np.ndarray  # (nb, K) float


def build_ell(pattern: BlockPattern) -> EllPattern:
    """The reference's ELL expansion: each row's stored blocks (as row) and
    strictly-upper blocks (as column, transposed), in pattern order; by one
    numpy sort."""
    nb = pattern.nb
    pos = np.arange(pattern.nnzb, dtype=np.int64)
    rows, cols = pattern.rows.astype(np.int64), pattern.cols.astype(np.int64)
    up = rows != cols
    row = np.concatenate([rows, cols[up]])
    col = np.concatenate([cols, rows[up]])
    sel = np.concatenate([pos, pos[up]])
    tr = np.concatenate([np.zeros(len(pos), bool), np.ones(int(up.sum()), bool)])
    order = np.lexsort((sel, row))
    row, col, sel, tr = row[order], col[order], sel[order], tr[order]
    counts = np.bincount(row, minlength=nb)
    K = int(counts.max())
    k = np.arange(len(row)) - np.concatenate([[0], np.cumsum(counts)[:-1]])[row]
    out_cols = np.zeros((nb, K), np.int32)
    out_sel = np.zeros((nb, K), np.int32)
    out_trans = np.zeros((nb, K), bool)
    valid = np.zeros((nb, K), np.float64)
    out_cols[row, k], out_sel[row, k], out_trans[row, k], valid[row, k] = col, sel, tr, 1.0
    return EllPattern(nb, pattern.d, K, out_cols, out_sel, out_trans, valid)


@dataclasses.dataclass(frozen=True)
class _EllTables:
    cols: torch.Tensor  # (nb, K) int32, what ell_matvec reads
    sel: torch.Tensor  # (nb, K) int64
    trans: torch.Tensor  # (nb, K) bool
    valid: torch.Tensor  # (nb, K) bool


def _ell_tables(ell: EllPattern, device) -> _EllTables:
    device = torch.device(device)
    key = ("ell", content_key(ell), str(device))
    if key not in _DEVICE_PLANS:
        _DEVICE_PLANS[key] = _EllTables(
            torch.as_tensor(ell.cols, dtype=torch.int32, device=device),
            torch.as_tensor(ell.sel, dtype=torch.int64, device=device),
            torch.as_tensor(ell.trans, device=device), torch.as_tensor(ell.valid > 0, device=device))
    return _DEVICE_PLANS[key]


def ell_blocks(H, ell: EllPattern):
    """Materialize the (nb, K, d, d) symmetric neighbor blocks from the
    upper BCSR store — once per damped system, outside the CG loop; padding
    slots hold zero blocks."""
    t = _ell_tables(ell, H.device)
    Hg = H[t.sel]  # (nb, K, d, d)
    He = torch.where(t.trans[:, :, None, None], Hg.transpose(-1, -2), Hg)
    return torch.where(t.valid[:, :, None, None], He, 0.0).contiguous()


def ell_matvec(He, ell: EllPattern, x):
    """y = H x from ELL blocks: the ``cuda_ops.ell_matvec`` kernel (its
    plain version on the CPU)."""
    return cuda_ops.ell_matvec(He, _ell_tables(ell, He.device).cols, x)


@dataclasses.dataclass(frozen=True)
class GroupJacobi:
    """Static layout of the group-diagonal preconditioner."""

    ng: int  # number of groups
    G: int  # poses per group
    d: int
    nb_pad: int
    sel: np.ndarray  # (ng, G, G) positions into the BCSR store (0 if none)
    trans: np.ndarray  # (ng, G, G) transpose flags
    valid: np.ndarray  # (ng, G, G) 1.0 where a stored block exists


def build_group_jacobi(pattern: BlockPattern, group_size: int = 8) -> GroupJacobi:
    """The reference's layout of G consecutive poses a group, by a numpy
    lookup of every in-group pair in the pattern."""
    nb, d, G = pattern.nb, pattern.d, group_size
    ng = -(-nb // G)
    nb_pad = ng * G
    i = (np.arange(ng)[:, None, None] * G + np.arange(G)[None, :, None]).repeat(G, 2)
    j = (np.arange(ng)[:, None, None] * G + np.arange(G)[None, None, :]).repeat(G, 1)
    keys_p = pattern.rows.astype(np.int64) * nb + pattern.cols.astype(np.int64)
    key = np.minimum(i, j) * nb + np.maximum(i, j)
    at = np.minimum(np.searchsorted(keys_p, key), max(len(keys_p) - 1, 0))
    found = (i < nb) & (j < nb) & (keys_p[at] == key)
    sel = np.where(found, at, 0).astype(np.int32)
    trans = found & (i > j)
    valid = found.astype(np.float64)
    return GroupJacobi(ng, G, d, nb_pad, sel, trans, valid)


def group_jacobi_factor(H, gj: GroupJacobi):
    """Gather the group-diagonal dense blocks and Cholesky-factorize them
    (NaN where a factorization fails).  Call once per damped system.
    Unfilled (padding) diagonal entries get a unit diagonal so the
    factorization is always SPD."""
    d, G = gj.d, gj.G
    key = ("group", content_key(gj), str(H.device))
    if key not in _DEVICE_PLANS:
        _DEVICE_PLANS[key] = (torch.as_tensor(gj.sel, dtype=torch.int64, device=H.device),
                              torch.as_tensor(gj.trans, device=H.device), torch.as_tensor(gj.valid > 0, device=H.device))
    sel, trans, valid = _DEVICE_PLANS[key]
    Hg = H[sel]  # (ng, G, G, d, d) gather
    Hg = torch.where(trans[..., None, None], Hg.transpose(-1, -2), Hg)
    Hg = torch.where(valid[..., None, None], Hg, 0.0)
    D = Hg.transpose(2, 3).reshape(gj.ng, G * d, G * d)
    diag = torch.diagonal(D, dim1=-2, dim2=-1)
    return _cholesky(D + torch.diag_embed((diag == 0.0).to(H.dtype)))


def group_jacobi_apply(L, gj: GroupJacobi, r):
    """M^{-1} r via batched triangular solves on the group factors."""
    n = r.shape[0]
    rp = torch.cat([r, r.new_zeros(gj.nb_pad * gj.d - n)]).reshape(gj.ng, gj.G * gj.d, 1)
    y = torch.linalg.solve_triangular(L, rp, upper=False)
    z = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return z.reshape(-1)[:n]


def solve_bcsr(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    pattern: BlockPattern | None = None,
    pcg_rtol: float = 1e-8,
    pcg_max_iters: int = 250,
    spmv: str = "ell",
    precond_group: int = 1,
):
    """GN/LM with block-sparse assembly + PCG linear solves.  Shares the LM
    trust-region loop with the dense path (``lm.solve``); returns
    (solved_graph, SolveInfo).

    ``spmv='ell'`` (default) expands the damped system into symmetric ELL
    neighbor lists once per linear solve, so each CG product is one
    ``ell_matvec`` launch; ``spmv='bcsr'`` uses the two-pass ``slot_reduce``
    product on the upper store.  ``precond_group`` > 1 uses the group
    block-Jacobi preconditioner over that many consecutive poses (1 =
    classic per-pose block-Jacobi).  PCG is ``schur_large._pcg`` unguarded:
    no host read inside a linear solve."""
    if spmv not in ("ell", "bcsr"):
        raise ValueError(f"spmv must be 'ell' or 'bcsr', got {spmv!r}")
    if pattern is None:
        pattern = build_pattern(graph)
    ell = build_ell(pattern) if spmv == "ell" else None
    gj = build_group_jacobi(pattern, precond_group) if precond_group > 1 else None
    nb, d = pattern.nb, pattern.d

    def assemble_fn(g):
        return assemble_bcsr(g, pattern)

    def solve_fn(H, g, lam, opt):
        Hd = damp_blocks(H, pattern, lam) if opt.method == "lm" else H
        if ell is not None:
            He = ell_blocks(Hd, ell)

            def matvec(x):
                return ell_matvec(He, ell, x)

        else:

            def matvec(x):
                return bcsr_matvec(Hd, pattern, x)

        if gj is not None:
            L_g = group_jacobi_factor(Hd, gj)

            def precond(r):
                return group_jacobi_apply(L_g, gj, r)

        else:
            Minv = block_jacobi_inv(Hd, pattern)

            def precond(r):
                return _mv(Minv, r.reshape(nb, d)).reshape(-1)

        dx, it = _pcg(matvec, precond, g, pcg_rtol, pcg_max_iters, read_every=0, guard=False)
        _CG_ITERATIONS.append(it)
        return dx

    return _lm.solve(graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn)
