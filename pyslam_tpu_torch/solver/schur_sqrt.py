"""Square-root (QR) landmark elimination for bundle adjustment.

Counterpart of ``pyslam_tpu/solver/schur_sqrt.py`` ("Square Root Bundle
Adjustment", arXiv 2109.02182): the conditioning-hardened alternative to
forming Hll = Jl^T Jl.

Math: stack each landmark's IRLS-whitened observation rows
[sqrt(w) Jl | sqrt(w) Jc | sqrt(w) r] and apply 3 batched Householder
reflections (QR of the 3-column landmark block).  The top 3 rows give the
landmark back-substitution (R dx_l = -b_top - B_top dx_p); the remaining
rows have no landmark involvement — they ARE the square root of the Schur
complement, so the reduced camera system assembled from them equals S in
exact arithmetic while never squaring Jl's condition number.  LM damping
enters as 3 augmented sqrt(lam * diag) rows per landmark before the QR.

Layout, as in the reference: landmarks bucketed on the host by their
observation count padded to a power of two (padded rows are zeroed and
inert); the reflections are broadcast products over a bucket; the reduced
camera system is dense (C*dp, C*dp), solved by ``cholesky_ex`` (NaN on
failure, no host read).  The reference's scatter-adds that sum duplicate
destinations — the camera-pair blocks of the reduced system
(``H.at[ia, :, ib, :].add``), its gradient rows (``grad.at[cams].add``)
and the pose-unary priors (``segment_sum``) — are ``slot_reduce`` over
plans built once per ``SqrtBAPlan`` from the buckets' cameras; the
block-diagonal pose columns and the landmark update are plain writes at
unique positions.  The LM iteration is the port's ``lm.solve`` through its
``assemble_fn`` / ``solve_fn`` extension points.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.core import FactorGraph
from . import lm as _lm
from .assemble import linearize_batch
from .cuda_ops import slot_longest, slot_plan, slot_reduce
from .linear import cholesky_solve
from .plan_cache import ClosureCache, content_key


@dataclasses.dataclass(frozen=True)
class SqrtBAPlan:
    """Host-side static bucketing of landmarks by observation count, and
    the ``slot_reduce`` plans of the sums into the reduced system."""

    pose_name: str
    lm_name: str
    C: int
    L: int
    dp: int
    dl: int
    m: int  # residual dim per observation
    pose_first: bool
    # per bucket: (lm_ids (Lb,), obs_idx (Lb, kpad), obs_mask (Lb, kpad))
    buckets: tuple
    # slot plans as (perm, offsets) int32 arrays: the camera-pair blocks of
    # every bucket's (l, a, b) in order into the camera pairs that receive
    # any (``pair_blocks``: their flat positions ca * C + cb, ascending);
    # the gradient rows of every bucket's (l, a) into C; each pose-unary
    # batch into C
    pair_plan: tuple
    pair_blocks: np.ndarray
    grad_plan: tuple
    unary_plans: tuple


def _pad_size(k):
    """Next power of two, floor 2."""
    p = 2
    while p < k:
        p *= 2
    return p


def build_sqrt_plan(graph: FactorGraph, pose_name: str = "poses", lm_name: str = "landmarks") -> SqrtBAPlan:
    """The buckets and slot plans of ``graph`` (host numpy; reads the
    observation and unary-prior indices once)."""
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    if lb.dof != 3:
        raise ValueError("schur_sqrt's Householder / back-substitution path is for 3-dof landmarks")
    binary = [fb for fb in graph.batches if fb.slots == (pose_name, lm_name)]
    if len(binary) != 1:
        raise ValueError("schur_sqrt expects exactly one pose-landmark batch")
    fb = binary[0]
    cam_idx = fb.indices[0].detach().cpu().numpy().astype(np.int64)
    pt_idx = fb.indices[1].detach().cpu().numpy().astype(np.int64)
    C, L = pb.n, lb.n
    order = np.argsort(pt_idx, kind="stable")
    counts = np.bincount(pt_idx, minlength=L)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pads = np.array([_pad_size(int(k)) for k in counts])

    buckets, pair_dest, grad_dest = [], [], []
    for kpad in sorted(set(pads[counts > 0].tolist())):
        lms = np.flatnonzero((pads == kpad) & (counts > 0))
        live = np.arange(kpad)[None, :] < counts[lms][:, None]
        src = np.minimum(starts[lms][:, None] + np.arange(kpad)[None, :], len(order) - 1)
        obs_idx = np.where(live, order[src], 0).astype(np.int32)
        buckets.append((lms.astype(np.int32), obs_idx, live.astype(np.float64)))
        cams = cam_idx[obs_idx]  # (Lb, kpad); a padded slot carries observation 0's camera
        pair_dest.append((cams[:, :, None] * C + cams[:, None, :]).reshape(-1))
        grad_dest.append(cams.reshape(-1))

    def plan_of(dest, n_slots):
        sp = slot_plan(dest, n_slots)
        return sp.perm, sp.offsets

    unary_plans = []
    for b in graph.batches:
        if b.slots == (pose_name,):
            unary_plans.append(plan_of(b.indices[0].detach().cpu().numpy(), C))
        elif b is not fb:
            raise ValueError(f"schur_sqrt: unsupported slots {b.slots}")

    r, _ = fb.evaluate(graph.blocks, compute_jacobians=False)
    names = list(graph.blocks)
    empty = np.zeros(0, np.int64)
    # only the camera pairs that co-observe get a slot: a plan over all C * C
    # would count the empty ones and give few pairs of thousands of rows
    # (clustered cameras) the sub-warp kernel
    pair_blocks, pair_slot = np.unique(np.concatenate(pair_dest) if pair_dest else empty, return_inverse=True)
    return SqrtBAPlan(
        pose_name=pose_name,
        lm_name=lm_name,
        C=C,
        L=L,
        dp=pb.dof,
        dl=lb.dof,
        m=int(r.shape[1]),
        pose_first=names.index(pose_name) < names.index(lm_name),
        buckets=tuple(buckets),
        pair_plan=plan_of(pair_slot.reshape(-1), len(pair_blocks)),
        pair_blocks=pair_blocks,
        grad_plan=plan_of(np.concatenate(grad_dest) if grad_dest else empty, C),
        unary_plans=tuple(unary_plans),
    )


def _householder_eliminate(A, Bb):
    """Batched QR elimination of the 3-column landmark block.

    A (L, n, 3); Bb (L, n, q) carries the pose columns AND the residual
    column so one reflection pass transforms everything.  Returns the
    transformed (A, Bb): A[:, :3, :3] is R (upper-triangular), rows >= 3 of
    A are ~0, and Bb rows >= 3 are the square-root reduced system."""
    n = A.shape[1]
    rows = torch.arange(n, device=A.device)
    for j in range(3):
        colmask = (rows >= j).to(A.dtype)
        x = A[:, :, j] * colmask[None, :]
        norm = torch.sqrt(torch.sum(x * x, dim=1))
        ajj = A[:, j, j]
        alpha = -torch.where(ajj >= 0, 1.0, -1.0).to(A.dtype) * norm
        v = x.clone()
        v[:, j] = v[:, j] - alpha
        vnorm2 = torch.sum(v * v, dim=1)
        ok = vnorm2 > 1e-30
        vn = v * (ok.to(A.dtype) / torch.sqrt(torch.where(ok, vnorm2, 1.0)))[:, None]
        A = A - 2.0 * vn[:, :, None] * torch.sum(vn[:, :, None] * A, dim=1)[:, None, :]
        Bb = Bb - 2.0 * vn[:, :, None] * torch.sum(vn[:, :, None] * Bb, dim=1)[:, None, :]
    return A, Bb


def _tri3_solve(R, rhs, live):
    """Back-substitute the 3x3 upper-triangular R (batched), guarded for
    dead / constant landmarks (live = 0 -> dx = 0)."""

    def guard(d):
        return torch.where(torch.abs(d) > 1e-30, d, torch.ones_like(d))

    d0, d1, d2 = guard(R[:, 0, 0]), guard(R[:, 1, 1]), guard(R[:, 2, 2])
    x2 = rhs[:, 2] / d2
    x1 = (rhs[:, 1] - R[:, 1, 2] * x2) / d1
    x0 = (rhs[:, 0] - R[:, 0, 1] * x1 - R[:, 0, 2] * x2) / d0
    return torch.stack([x0, x1, x2], dim=1) * live[:, None]


def _closures(plan: SqrtBAPlan, device):
    """(assemble_fn, solve_fn) of ``plan`` with its tables on ``device``."""
    C, dp, dl, m = plan.C, plan.dp, plan.dl, plan.m

    def t(a, dtype=torch.int64):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    buckets = [(t(lms), t(obs_idx), t(mask, torch.float64)) for lms, obs_idx, mask in plan.buckets]
    pair_perm, pair_off = (t(a, torch.int32) for a in plan.pair_plan)
    pair_blocks = t(plan.pair_blocks)
    grad_perm, grad_off = (t(a, torch.int32) for a in plan.grad_plan)
    pair_longest, grad_longest = slot_longest(plan.pair_plan[1]), slot_longest(plan.grad_plan[1])
    unary = [(*(t(a, torch.int32) for a in p), slot_longest(p[1])) for p in plan.unary_plans]

    def assemble_fn(g):
        """The raw linearization pieces as 'H' (a dict); the elimination
        happens in solve_fn, where lam is known."""
        pb, lb = g.blocks[plan.pose_name], g.blocks[plan.lm_name]
        dtype = pb.values.dtype
        chi2 = torch.zeros((), dtype=dtype, device=device)
        pieces = {"buckets": [], "unary": []}
        u = 0
        for fb in g.batches:
            r, jacs, w, c2 = linearize_batch(fb, g.blocks)
            chi2 = chi2 + c2
            if fb.slots == (plan.pose_name, plan.lm_name):
                sw = torch.sqrt(w)
                Jc = jacs[0] * sw[..., None]
                Jl = jacs[1] * sw[..., None]
                rw = sw * r
                ci = fb.indices[0]
                for lms, obs_idx, obs_mask in buckets:
                    msk = obs_mask.to(dtype)
                    pieces["buckets"].append(dict(
                        lms=lms,
                        cams=ci[obs_idx],  # (Lb, kpad)
                        A=Jl[obs_idx] * msk[..., None, None],
                        B=Jc[obs_idx] * msk[..., None, None],
                        b=rw[obs_idx] * msk[..., None],
                        mask=msk,
                    ))
            else:  # a pose-unary batch (build_sqrt_plan refused the others)
                (J,) = jacs
                perm, off, longest = unary[u]
                u += 1
                JtW = J.transpose(1, 2) * w[:, None, :]
                Hu = slot_reduce((JtW @ J).reshape(J.shape[0], dp * dp).contiguous(), perm, off, C, longest)
                gu = -slot_reduce((JtW @ r[..., None])[..., 0].contiguous(), perm, off, C, longest)
                pieces["unary"].append((Hu.reshape(C, dp, dp), gu))
        pieces["free_p"] = (~pb.const_mask).to(dtype)
        pieces["free_l"] = (~lb.const_mask).to(dtype)
        return pieces, torch.zeros(g.total_dof, dtype=dtype, device=device), chi2

    def solve_fn(pieces, g_unused, lam, opt):
        dtype = g_unused.dtype
        free_p, free_l = pieces["free_p"], pieces["free_l"]
        eliminated, pair_rows, grad_rows = [], [], []
        for bk in pieces["buckets"]:
            Lb, kpad = bk["mask"].shape
            n = kpad * m + 3  # + square-root damping rows
            fl = free_l[bk["lms"]]
            # constant landmarks: zero their A block -> rows become pure pose
            # rows; R degenerates and _tri3_solve guards dx_l = 0
            A = (bk["A"] * fl[:, None, None, None]).reshape(Lb, kpad * m, dl)
            # pose columns per observation slot + the residual column: row
            # group s only touches its own camera block, so the block-diagonal
            # (Lb, kpad*m, kpad*dp) layout is written at unique positions
            rows = torch.arange(kpad * m, device=device)
            Bfull = torch.zeros((Lb, kpad * m, kpad, dp), dtype=dtype, device=device)
            Bfull[:, rows, rows // m] = bk["B"].reshape(Lb, kpad * m, dp)
            Bb = torch.cat([Bfull.reshape(Lb, kpad * m, kpad * dp), bk["b"].reshape(Lb, kpad * m, 1)], dim=-1)
            # square-root Marquardt damping rows for the landmark block
            if opt.method == "lm":
                colnorm = torch.sqrt(torch.sum(A * A, dim=1))  # (Lb, 3)
                aug = torch.sqrt(lam) * torch.clamp(colnorm, min=1e-12)
            else:
                aug = torch.zeros((Lb, dl), dtype=dtype, device=device)
            A_aug = torch.cat([A, aug[:, :, None] * torch.eye(dl, dtype=dtype, device=device)[None]], dim=1)
            Bb_aug = torch.cat([Bb, torch.zeros((Lb, dl, Bb.shape[-1]), dtype=dtype, device=device)], dim=1)
            A_t, Bb_t = _householder_eliminate(A_aug, Bb_aug)
            R = A_t[:, :3, :3]
            B_top = Bb_t[:, :3, :-1].reshape(Lb, 3, kpad, dp)
            b_top = Bb_t[:, :3, -1]
            B_red = Bb_t[:, 3:, :-1].reshape(Lb, n - 3, kpad, dp)
            b_red = Bb_t[:, 3:, -1]
            # reduced-system contributions (dense camera blocks)
            pair_rows.append(torch.einsum("lnai,lnbj->labij", B_red, B_red).reshape(-1, dp * dp))
            grad_rows.append(-torch.einsum("lnai,ln->lai", B_red, b_red).reshape(-1, dp))
            eliminated.append((bk, R, B_top, b_top, fl))

        # the sums over duplicate destinations: one slot_reduce each; the
        # camera-pair sums written into their blocks at unique positions
        H = torch.zeros((C * C, dp * dp), dtype=dtype, device=device)
        if pair_rows:
            H[pair_blocks] = slot_reduce(torch.cat(pair_rows).contiguous(), pair_perm, pair_off, len(plan.pair_blocks),
                                         pair_longest)
            grad = slot_reduce(torch.cat(grad_rows).contiguous(), grad_perm, grad_off, C, grad_longest)
        else:
            grad = torch.zeros((C, dp), dtype=dtype, device=device)
        H = H.reshape(C, C, dp, dp).permute(0, 2, 1, 3).reshape(C, dp, C, dp)
        cam = torch.arange(C, device=device)
        for Hu, gu in pieces["unary"]:
            H[cam, :, cam, :] += Hu
            grad = grad + gu

        # frozen poses + pose damping on the dense reduced system
        Hm = H.reshape(C * dp, C * dp)
        fp = free_p.repeat_interleave(dp)
        Hm = Hm * fp[:, None] * fp[None, :] + torch.diag(1.0 - fp)
        # dead pose dofs (cameras with no observations)
        Hm = Hm + torch.diag((torch.diagonal(Hm) == 0.0).to(dtype))
        if opt.method == "lm":
            dd = torch.clamp(torch.diagonal(Hm), min=1e-12)
            Hm = Hm + lam * torch.diag(dd)
        gv = (grad * free_p[:, None]).reshape(-1)
        dx_p = cholesky_solve(Hm, gv).reshape(C, dp) * free_p[:, None]

        # landmark back-substitution per bucket (unique positions)
        dx_l = torch.zeros((plan.L, dl), dtype=dtype, device=device)
        for bk, R, B_top, b_top, fl in eliminated:
            dxp_g = dx_p[bk["cams"]]  # (Lb, kpad, dp)
            rhs = -b_top - torch.einsum("lrkd,lkd->lr", B_top, dxp_g)
            dx_l[bk["lms"]] = _tri3_solve(R, rhs, fl)

        segs = [dx_p.reshape(-1), dx_l.reshape(-1)]
        return torch.cat(segs if plan.pose_first else segs[::-1])

    return assemble_fn, solve_fn


def solve_schur_sqrt(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    plan: SqrtBAPlan | None = None,
):
    """GN/LM bundle adjustment with square-root (QR) landmark elimination.
    Same semantics as solve_schur (converges to the same chi2); numerically
    preferable in f32 when Jl is ill-conditioned (low-parallax landmarks).
    Supports one pose-landmark batch plus pose-unary prior batches.
    Returns (solved_graph, SolveInfo)."""
    if plan is None:
        plan = build_sqrt_plan(graph, pose_name, lm_name)
    device = graph.blocks[plan.pose_name].values.device
    key = ("sqrt", content_key(plan), str(device))
    if key not in _CLOSURES:
        _CLOSURES[key] = _closures(plan, device)
    assemble_fn, solve_fn = _CLOSURES[key]
    return _lm.solve(graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn)


_CLOSURES = ClosureCache()

__all__ = ["solve_schur_sqrt", "build_sqrt_plan", "SqrtBAPlan"]
