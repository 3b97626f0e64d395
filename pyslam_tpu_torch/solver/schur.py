"""Schur-complement bundle adjustment: landmark marginalization on the device.

Counterpart of ``pyslam_tpu/solver/schur.py``.  The landmark block-diagonal
``Hll`` (dl x dl blocks) is eliminated in one batched pass and only the
reduced camera system ``S`` is solved:

    S       = Hpp - Hpl Hll^-1 Hlp
    g_red   = g_p - Hpl Hll^-1 g_l
    S dx_p  = g_red
    dx_l    = Hll^-1 (g_l - Hlp dx_p)

Two linear-solve modes share the LM loop of ``lm.solve``:

  * ``mode='dense'`` materializes S (C dp x C dp) and factorizes it with a
    dense Cholesky.  Right for up to a few thousand cameras.
  * ``mode='pcg'`` never materializes S: an implicit Schur product (two
    gathers, two segment sums and a batched dl x dl product per
    application) under the exact block-Jacobi preconditioner of S.

The module is dof-generic: 6-dof ``se3`` or 9-dof ``bal_cam9`` cameras with
3-dof points, 3-dof ``se2`` poses with 2-dof landmarks.

Every segment sum (by camera, by landmark, by either pose of a pose-pose
factor, by (camera, landmark) pair) is the ``slot_reduce`` kernel over a
plan sorted once per solve on the host (``schur_plan``), and every scatter
into a dense matrix writes reduced blocks to unique positions.  So two runs
give the same bits, which ``index_add_`` and an accumulating ``index_put_``
do not on a CUDA device.  A factorization that fails gives NaN blocks
without a host read (``cholesky_ex``); the NaN step is rejected by the LM
loop.  The reference runs everything inside one ``lax.while_loop``; here the
LM loop reads once per iteration (``lm.solve``) and the CG loop of
``mode='pcg'`` once per CG iteration (``linear.pcg_solve``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..graph.core import FactorGraph
from . import lm as _lm
from .assemble import linearize_batch
from .cuda_ops import slot_plan, slot_reduce
from .linear import cholesky_solve, pcg_solve

# --------------------------------------------------------------------------
# The plan: every index table of one graph structure, built once per solve
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segments:
    """A ``slot_reduce`` plan on the graph's device: ``sum(x)`` adds the
    rows of x (E, ...) that share a destination, in the plan's order."""

    perm: torch.Tensor  # (E,) int32
    offsets: torch.Tensor  # (n_slots + 1,) int32
    n_slots: int
    longest: int | None = None  # the plan's longest segment (``slot_reduce``'s ``longest``)

    def sum(self, x):
        """(E, *shape) -> (n_slots, *shape)."""
        width = math.prod(x.shape[1:])  # not -1: x may have no rows
        out = slot_reduce(x.reshape(x.shape[0], width).contiguous(), self.perm, self.offsets, self.n_slots,
                          self.longest)
        return out.reshape((self.n_slots,) + x.shape[1:])


@dataclasses.dataclass(frozen=True)
class SchurPlan:
    """Static tables of a camera / landmark graph.  Index tensors are int64
    on the graph's device.  ``roles`` names each batch: 'obs' (pose,
    landmark), 'obs_lp' (landmark, pose), 'pose' (pose,), 'lm' (landmark,),
    'pp' (pose, pose)."""

    C: int
    dp: int
    L: int
    dl: int
    pose_first: bool  # the pose block comes first in the global tangent
    roles: tuple
    to_pose: Segments  # every contribution to a pose's block or gradient row, in stacking order
    to_lm: Segments  # every contribution to a landmark's
    cam_idx: torch.Tensor  # (M,) the observations of all 'obs' batches
    pt_idx: torch.Tensor
    by_cam: Segments  # the M observations by camera
    by_lm: Segments  # ... by landmark
    pair_cam: torch.Tensor  # (U,) the unique (camera, landmark) pairs
    pair_lm: torch.Tensor
    by_pair: Segments  # the M observations by pair
    pp_i: torch.Tensor  # (P,) the factors of all 'pp' batches
    pp_j: torch.Tensor
    by_pp_i: Segments
    by_pp_j: Segments
    pp_pair_i: torch.Tensor  # (V,) the unique blocks of S that [PP, PP^T] go to
    pp_pair_j: torch.Tensor
    by_pp_pair: Segments  # the 2 P blocks [PP (i, j), PP^T (j, i)] by block of S


def schur_host_tables(graph: FactorGraph, pose_name: str = "poses", lm_name: str = "landmarks") -> dict:
    """The plan's index arrays on the host (numpy int64), validated:
    ``roles``; ``to_pose`` / ``to_lm``, every contribution to a pose's /
    landmark's block in stacking order; ``cam`` / ``pt``, the observations
    in the order ``ba_assemble`` stacks W (both slot orders); ``pi`` /
    ``pj``, the (pose, pose) factors in the order it stacks PP.  Raises on a
    slot pattern the Schur path does not take and on a factor index outside
    its block, which the reference would clamp silently."""
    patterns = {(pose_name, lm_name): "obs", (lm_name, pose_name): "obs_lp", (pose_name,): "pose",
                (lm_name,): "lm", (pose_name, pose_name): "pp"}
    roles, to_pose, to_lm, cams, pts, pis, pjs = [], [], [], [], [], [], []
    for fb in graph.batches:
        role = patterns.get(tuple(fb.slots))
        if role is None:
            raise ValueError(
                f"Schur path: unsupported slot pattern {fb.slots}; expected "
                f"({pose_name},), ({lm_name},), ({pose_name}, {pose_name}), "
                f"({pose_name}, {lm_name}) or ({lm_name}, {pose_name})"
            )
        idx = [i.detach().cpu().numpy().astype(np.int64) for i in fb.indices]
        for slot, i in zip(fb.slots, idx):
            n = graph.blocks[slot].n
            if len(i) and (i.min() < 0 or i.max() >= n):
                raise ValueError(
                    f"factor batch {fb.kind!r} slot {slot!r}: index out of range "
                    f"[0, {n}) (min {i.min()}, max {i.max()})"
                )
        roles.append(role)
        if role == "obs":
            to_pose.append(idx[0])
            to_lm.append(idx[1])
            cams.append(idx[0])
            pts.append(idx[1])
        elif role == "obs_lp":
            to_lm.append(idx[0])
            to_pose.append(idx[1])
            cams.append(idx[1])
            pts.append(idx[0])
        elif role == "pose":
            to_pose.append(idx[0])
        elif role == "lm":
            to_lm.append(idx[0])
        else:
            to_pose += idx
            pis.append(idx[0])
            pjs.append(idx[1])

    def cat(arrays):
        return np.concatenate(arrays) if arrays else np.zeros(0, np.int64)

    return dict(roles=tuple(roles), to_pose=cat(to_pose), to_lm=cat(to_lm), cam=cat(cams), pt=cat(pts),
                pi=cat(pis), pj=cat(pjs))


def schur_plan(graph: FactorGraph, pose_name: str = "poses", lm_name: str = "landmarks") -> SchurPlan:
    """Build the plan on the host (numpy, ``schur_host_tables``) and put its
    tables on the graph's device."""
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    C, L = pb.n, lb.n
    device = pb.values.device
    host = schur_host_tables(graph, pose_name, lm_name)

    def index(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)

    made = {}

    def segments(dest, n_slots):
        # equal destinations share one plan (a graph of observations only
        # sums its assembly by the cameras and landmarks of the observations)
        key = (dest.tobytes(), n_slots)
        if key not in made:
            sp = slot_plan(dest, n_slots)
            made[key] = Segments(
                torch.as_tensor(sp.perm, device=device), torch.as_tensor(sp.offsets, device=device), n_slots,
                sp.longest)
        return made[key]

    def pairs(rows, cols, n_cols):
        uniq, dest = np.unique(rows * n_cols + cols, return_inverse=True)
        return index(uniq // n_cols), index(uniq % n_cols), segments(dest.reshape(-1), len(uniq))

    cam, pt, pi, pj = host["cam"], host["pt"], host["pi"], host["pj"]
    pair_cam, pair_lm, by_pair = pairs(cam, pt, L)
    pp_pair_i, pp_pair_j, by_pp_pair = pairs(np.concatenate([pi, pj]), np.concatenate([pj, pi]), C)
    names = list(graph.blocks)
    return SchurPlan(
        C=C, dp=pb.dof, L=L, dl=lb.dof, pose_first=names.index(pose_name) < names.index(lm_name),
        roles=host["roles"], to_pose=segments(host["to_pose"], C), to_lm=segments(host["to_lm"], L),
        cam_idx=index(cam), pt_idx=index(pt), by_cam=segments(cam, C), by_lm=segments(pt, L),
        pair_cam=pair_cam, pair_lm=pair_lm, by_pair=by_pair,
        pp_i=index(pi), pp_j=index(pj), by_pp_i=segments(pi, C), by_pp_j=segments(pj, C),
        pp_pair_i=pp_pair_i, pp_pair_j=pp_pair_j, by_pp_pair=by_pp_pair,
    )


# --------------------------------------------------------------------------
# Small batched linear algebra
# --------------------------------------------------------------------------


# The small block products are broadcast products summed over the short
# axis, not ``torch.matmul``: a batched product of millions of 3 x 3 or
# 6 x 3 blocks, one block a batch entry, is what cuBLAS is worst at (on an
# H100 at bench config 6's shapes, 6 to 13 times slower: PERF.md).


def _mv(A, x):
    """Batched A x."""
    return (A * x[..., None, :]).sum(-1)


def _tmv(A, x):
    """Batched A^T x."""
    return (A * x[..., :, None]).sum(-2)


def _mm(A, B):
    """Batched A B: (..., a, k), (..., k, b) -> (..., a, b)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _jtwj(Ja, w, Jb):
    """Per-factor Ja^T diag(w) Jb: (F, m, a), (F, m), (F, m, b) -> (F, a, b)."""
    return _mm(Ja.transpose(-1, -2), w[..., None] * Jb)


def _cholesky(A):
    """Batched lower Cholesky factors; NaN blocks where A is not positive
    definite (no exception, no host read)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], float("nan"), L)


def _binv(L):
    """Explicit batched inverse from Cholesky factors."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    Y = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


# --------------------------------------------------------------------------
# Assembly
# --------------------------------------------------------------------------


def ba_assemble(graph: FactorGraph, pose_name: str = "poses", lm_name: str = "landmarks",
                plan: SchurPlan | None = None):
    """Block-structured normal equations for a camera/landmark graph.

    Returns ``(parts, g, chi2)`` where ``parts`` carries the block pieces
    (Hpp (C, dp, dp), Hll (L, dl, dl), per-observation coupling W (M, dp,
    dl) with its camera / landmark index tensors, per-factor pose-pose
    coupling PP (P, dp, dp) with its index tensors, g_p, g_l, the Python
    bool ``pose_first`` and the ``plan``) and ``g`` is the concatenated
    global gradient: the ``assemble_fn`` contract of ``lm.solve``.

    Supported batch shapes: (pose,) unary factors -> Hpp; (landmark,) unary
    -> Hll; (pose, landmark) and (landmark, pose) binary observations -> Hpp
    + Hll + W; (pose, pose) binary factors -> Hpp + PP.  ``plan`` (from ``schur_plan``) is
    built here when not given.
    """
    if plan is None:
        plan = schur_plan(graph, pose_name, lm_name)
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    C, dp, L, dl = plan.C, plan.dp, plan.L, plan.dl
    dtype, device = pb.values.dtype, pb.values.device

    chi2 = torch.zeros((), dtype=dtype, device=device)
    # contributions in the plan's stacking order
    Hp, gp, Hl, gl, Ws, PPs = [], [], [], [], [], []
    pose, lm = (Hp, gp), (Hl, gl)
    slots = {"obs": (pose, lm), "obs_lp": (lm, pose), "pose": (pose,), "lm": (lm,), "pp": (pose, pose)}
    for fb, role in zip(graph.batches, plan.roles):
        r, jacs, w, c2 = linearize_batch(fb, graph.blocks)
        chi2 = chi2 + c2
        wr = w * r
        for J, (H_parts, g_parts) in zip(jacs, slots[role]):
            H_parts.append(_jtwj(J, w, J))
            g_parts.append(_tmv(J, wr))
        if role == "obs":
            Ws.append(_jtwj(jacs[0], w, jacs[1]))
        elif role == "obs_lp":
            Ws.append(_jtwj(jacs[1], w, jacs[0]))
        elif role == "pp":
            # the off-diagonal pose-pose coupling stays per factor: the S
            # solve applies it (dense scatter or two segment sums a product)
            PPs.append(_jtwj(jacs[0], w, jacs[1]))

    def total(segments, parts, shape):
        if not parts:
            return torch.zeros((segments.n_slots,) + shape, dtype=dtype, device=device)
        return segments.sum(torch.cat(parts))

    def stack(parts, shape):
        return torch.cat(parts) if parts else torch.zeros((0,) + shape, dtype=dtype, device=device)

    Hpp = total(plan.to_pose, Hp, (dp, dp))
    g_p = -total(plan.to_pose, gp, (dp,))
    Hll = total(plan.to_lm, Hl, (dl, dl))
    g_l = -total(plan.to_lm, gl, (dl,))
    W = stack(Ws, (dp, dl))
    PP = stack(PPs, (dp, dp))
    Hpp, g_p, Hll, g_l, W, PP = mask_constants(plan, Hpp, g_p, Hll, g_l, W, PP, (~pb.const_mask).to(dtype),
                                               (~lb.const_mask).to(dtype))
    parts = dict(
        Hpp=Hpp, Hll=Hll, W=W, g_p=g_p, g_l=g_l, cam_idx=plan.cam_idx, pt_idx=plan.pt_idx,
        PP=PP, pp_i=plan.pp_i, pp_j=plan.pp_j, pose_first=plan.pose_first, plan=plan,
    )
    return parts, _concat_dx(parts, g_p, g_l), chi2


def mask_constants(plan, Hpp, g_p, Hll, g_l, W, PP, free_p, free_l):
    """Constant variables (``free_*`` 0.0): zero their blocks everywhere,
    unit diagonal so the factorizations stay SPD and their tangent update
    is exactly 0.  Unobserved free landmarks (all-zero Hll block) likewise:
    their g_l is 0, so dx_l = 0 and they are inert.  ``plan`` gives the
    observations' and the (pose, pose) factors' indices (``cam_idx``,
    ``pt_idx``, ``pp_i``, ``pp_j``).  Returns (Hpp, g_p, Hll, g_l, W, PP)."""
    eye_p = torch.eye(Hpp.shape[-1], dtype=Hpp.dtype, device=Hpp.device)
    eye_l = torch.eye(Hll.shape[-1], dtype=Hll.dtype, device=Hll.device)
    Hpp = Hpp * free_p[:, None, None] + (1.0 - free_p)[:, None, None] * eye_p
    g_p = g_p * free_p[:, None]
    dead_l = (torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1) == 0.0).to(Hll.dtype)
    live_l = free_l * (1.0 - dead_l)
    Hll = Hll * live_l[:, None, None] + (1.0 - live_l)[:, None, None] * eye_l
    g_l = g_l * live_l[:, None]
    W = W * free_p[plan.cam_idx][:, None, None] * live_l[plan.pt_idx][:, None, None]
    PP = PP * free_p[plan.pp_i][:, None, None] * free_p[plan.pp_j][:, None, None]
    return Hpp, g_p, Hll, g_l, W, PP


def _concat_dx(parts, dx_p, dx_l):
    """The global tangent in the graph's (sorted) block order."""
    segs = [dx_p.reshape(-1), dx_l.reshape(-1)]
    return torch.cat(segs if parts["pose_first"] else segs[::-1])


# --------------------------------------------------------------------------
# Linear solves
# --------------------------------------------------------------------------


def _damp_blocks(H, lam, floor=1e-12):
    """Marquardt damping per diagonal block: H_ii += lam * diag(H_ii)."""
    d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=floor)
    return H + lam * torch.diag_embed(d)


def _schur_reduce(parts, lam, method, cam_sum=None):
    """Damp, invert Hll (by its Cholesky factors: NaN blocks where one is
    not positive definite), and form the reduced RHS.  Returns the pieces
    the solve modes share: (damped Hpp, Hll^-1, W, g_red).  ``cam_sum``:
    the sum of per-observation rows by camera, ``plan.by_cam.sum`` where it
    is None (the landmark-sharded solver adds a sum over the ranks)."""
    Hpp, Hll, W, plan = parts["Hpp"], parts["Hll"], parts["W"], parts["plan"]
    cam_sum = cam_sum or plan.by_cam.sum
    if method == "lm":
        Hpp = _damp_blocks(Hpp, lam)
        Hll = _damp_blocks(Hll, lam)
    Hll_inv = _binv(_cholesky(Hll))
    # reduced gradient: g_p - W Hll^-1 g_l  (per-observation gather, segment sum)
    t = _mv(Hll_inv, parts["g_l"])
    g_red = parts["g_p"] - cam_sum(_mv(W, t[plan.pt_idx]))
    return Hpp, Hll_inv, W, g_red


def _back_substitute(Hll_inv, W, plan, g_l, dx_p):
    """dx_l = Hll^-1 (g_l - W^T dx_p), per-landmark batched."""
    t = g_l - plan.by_lm.sum(_tmv(W, dx_p[plan.cam_idx]))
    return _mv(Hll_inv, t)


def schur_block_diag(plan, Hpp, Hll_inv, W, cam_sum=None):
    """The exact block diagonal of S: D_c = Hpp_c - sum_{m: cam_m = c} W_m
    Hll^-1 W_m^T (cross terms vanish because a camera observes a landmark at
    most once; a duplicate observation only makes the preconditioner
    approximate, never the solve wrong).  ``Hpp`` as damped; ``cam_sum`` as
    in ``_schur_reduce``."""
    cam_sum = cam_sum or plan.by_cam.sum
    return Hpp - cam_sum(_mm(_mm(W, Hll_inv[plan.pt_idx]), W.transpose(-1, -2)))


def schur_matvec(plan, Hpp, Hll_inv, W, PP, cam_sum=None):
    """x (C dp,) -> S x, S = Hpp + the pose-pose couplings PP - W Hll^-1
    W^T, never formed: two gathers, two segment sums and a batched dl x dl
    product (two more sums with couplings).  ``plan`` gives the index
    tensors and the ``slot_reduce`` plans by camera, landmark and either
    pose of a coupling; ``cam_sum`` as in ``_schur_reduce`` (the couplings
    are not part of it)."""
    C, dp = Hpp.shape[0], Hpp.shape[-1]
    ci, li, pp_i, pp_j = plan.cam_idx, plan.pt_idx, plan.pp_i, plan.pp_j
    cam_sum = cam_sum or plan.by_cam.sum

    def matvec(x):
        xb = x.reshape(C, dp)
        y = _mv(Hpp, xb)
        if PP.shape[0]:  # pose-pose coupling (full-SLAM between factors)
            y = y + plan.by_pp_i.sum(_mv(PP, xb[pp_j]))
            y = y + plan.by_pp_j.sum(_tmv(PP, xb[pp_i]))
        t = _mv(Hll_inv, plan.by_lm.sum(_tmv(W, xb[ci])))
        y = y - cam_sum(_mv(W, t[li]))
        return y.reshape(-1)

    return matvec


def block_jacobi(D_inv):
    """The block-Jacobi preconditioner r -> D^-1 r from explicit inverse
    blocks D_inv (C, dp, dp)."""
    C, dp = D_inv.shape[0], D_inv.shape[-1]

    def precond(r):
        return _mv(D_inv, r.reshape(C, dp)).reshape(-1)

    return precond


def schur_solve_dense(parts, g, lam, opt: _lm.Options):
    """Materialized-S path: Hpl (C dp x L dl) scattered block by block, S =
    blockdiag(Hpp) - Hpl Hll^-1 Hpl^T by two matrix products, dense
    Cholesky."""
    plan = parts["plan"]
    Hpp, Hll_inv, W, g_red = _schur_reduce(parts, lam, opt.method)
    C, dp, L, dl = plan.C, plan.dp, plan.L, plan.dl
    # a camera that sees a landmark twice adds both blocks: summed by pair,
    # then one write per block
    Hpl = Hpp.new_zeros((C, dp, L, dl))
    Hpl[plan.pair_cam, :, plan.pair_lm, :] = plan.by_pair.sum(W)
    Ypl = torch.einsum("alk,lkj->alj", Hpl.reshape(C * dp, L, dl), Hll_inv)  # Hpl Hll^-1
    S = -(Ypl.reshape(C * dp, L * dl) @ Hpl.reshape(C * dp, L * dl).T)
    S = S.reshape(C, dp, C, dp)
    diag = torch.arange(C, device=S.device)
    S[diag, :, diag, :] += Hpp  # unique blocks
    # pose-pose off-diagonal coupling (full-SLAM graphs: between factors)
    PP = parts["PP"]
    if PP.shape[0]:
        blocks = plan.by_pp_pair.sum(torch.cat([PP, PP.transpose(-1, -2)]))
        S[plan.pp_pair_i, :, plan.pp_pair_j, :] += blocks  # unique blocks
    dx_p = cholesky_solve(S.reshape(C * dp, C * dp), g_red.reshape(-1)).reshape(C, dp)
    dx_l = _back_substitute(Hll_inv, W, plan, parts["g_l"], dx_p)
    return _concat_dx(parts, dx_p, dx_l)


def schur_solve_pcg(parts, g, lam, opt: _lm.Options, rtol=1e-8, max_iters=200):
    """Implicit-S path: PCG on S without materializing it.  One product with
    S is two gathers, two segment sums and a batched dl x dl product.
    Preconditioner: the exact diagonal blocks of S."""
    plan = parts["plan"]
    Hpp, Hll_inv, W, g_red = _schur_reduce(parts, lam, opt.method)
    C, dp = plan.C, plan.dp
    # Applied as an explicit inverse (one batched product an iteration, as
    # ``solve_ell`` applies its block-Jacobi inverse) where the reference
    # solves with the two triangular factors.
    precond = block_jacobi(_binv(_cholesky(schur_block_diag(plan, Hpp, Hll_inv, W))))
    matvec = schur_matvec(plan, Hpp, Hll_inv, W, parts["PP"])
    dx_p, _ = pcg_solve(matvec, g_red.reshape(-1), precond=precond, rtol=rtol, max_iters=max_iters)
    dx_p = dx_p.reshape(C, dp)
    dx_l = _back_substitute(Hll_inv, W, plan, parts["g_l"], dx_p)
    return _concat_dx(parts, dx_p, dx_l)


def solve_schur(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    mode: str = "dense",
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    pcg_rtol: float = 1e-8,
    pcg_max_iters: int = 200,
):
    """GN/LM bundle adjustment with Schur-complement linear solves.
    Returns (solved_graph, SolveInfo).

    The dx of every step follows the graph's canonical (sorted-name)
    tangent layout: ``ba_assemble`` records the order so both modes match
    it."""
    if mode == "dense":
        solve_fn = schur_solve_dense
    elif mode == "pcg":

        def solve_fn(parts, g, lam, opt):
            return schur_solve_pcg(parts, g, lam, opt, rtol=pcg_rtol, max_iters=pcg_max_iters)

    else:
        raise ValueError(f"unknown Schur mode {mode!r}")
    plan = schur_plan(graph, pose_name, lm_name)

    def assemble_fn(g):
        return ba_assemble(g, pose_name, lm_name, plan)

    return _lm.solve(graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn)
