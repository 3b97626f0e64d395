"""Venice-scale bundle adjustment on one device: the Schur path with its
plan built once per graph structure.

Counterpart of ``pyslam_tpu/solver/schur_large.py`` (``prepare_large_ba``,
``solve_schur_large``, ``build_dense_pairs``, ``DensePairs``, ``LargeBA``),
with the reference's semantics and another layout.  The reference stores
every per-observation quantity component-major, sums by camera with cumsum
boundary differences and drives long CG runs in host segments, three
answers to a TPU's tile padding, slow scatters and program time limit.  A
GPU has none of the three, so here:

* per-observation blocks keep their natural layout: W (M, dp, 3) is 335 MB
  in f32 at 4.65M observations of 6-dof cameras;
* the observations are sorted stably by camera once (``prepare_large_ba``),
  and every sum by camera or by landmark is ``cuda_ops.slot_reduce`` over a
  plan built then: the same order, and the same bits, on every call;
* the linearization writes each observation's rows into full-length
  buffers (``rows_of(dp)``: dp camera gradient and dp (dp + 1) / 2 camera
  Hessian terms, 3 landmark gradient and 6 landmark Hessian terms, the 3 dp
  of W; 54 for ``se3`` cameras, 90 for BAL's 9-parameter ``bal_cam9``
  ones), and its cost, which are then summed once.  Monocular BAL
  observations (``reprojection_bal`` on ``se3`` cameras,
  ``reprojection_bal9`` on ``bal_cam9`` ones) under an elementwise loss
  take one launch of ``cuda_ops.bal_rows``,
  whose Jacobians stay in registers (on the CPU its plain twin, over the
  same chunks as the rest); every other observation kind runs the port's
  factor kernel over ``n_chunks`` chunks of the observation axis (the
  chunk bounds the memory of the Jacobians).  Either way ``n_chunks``
  changes no result;
* PCG on the reduced camera system applies its stop rule before every
  iteration at every budget, on the device; the reference does so only for
  budgets up to 60 and tests larger ones every 25 iterations (its
  ``_pcg_segment``).

The Schur algebra is ``solver/schur.py``'s, on this plan: the masks
(``mask_constants``), the damping, Hll⁻¹ and the reduced gradient
(``_schur_reduce``), the block diagonal of S (``schur_block_diag``), the
Schur product (``schur_matvec``) and the back-substitution.  A 3 x 3
landmark block or a dp x dp block of D that is not positive definite
factors to NaN, without a host read; the LM loop rejects that step.

The LM loop is ``host_loop.host_lm_loop_speculative`` (default) or
``host_lm_loop`` with the cost-only pass; both read once an LM iteration.

Beyond the reference, whose plan takes ``se3`` cameras only, the plan
takes BAL's 9-parameter ``bal_cam9`` cameras (SE(3) x [f, k1, k2]): every
piece above reads the camera's dof from the plan (``LargeBA.dp``) and its
retraction from its kind (``LargeBA.pose_kind``).
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch

from ..graph.core import FACTOR_KERNELS, FactorGraph, VariableBlock, retract
from ..observability import span
from . import lm as _lm
from .cuda_ops import _stable_argsort, bal_rows, kernel_loss, rows_of, slot_plan
from .host_loop import host_lm_loop, host_lm_loop_speculative
from .linear import HOST_READS, cholesky_solve
from .schur import (Segments, _back_substitute, _binv, _cholesky, _jtwj, _mm, _schur_reduce, _tmv, block_jacobi,
                    mask_constants, schur_block_diag, schur_matvec)

# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------

# the camera kinds of the plan, and the observation kind each takes to
# ``cuda_ops.bal_rows``
CAMERAS = {"se3": "reprojection_bal", "bal_cam9": "reprojection_bal9"}


def camera_width(dp: int) -> int:
    """The rows of a camera's sums: its gradient and upper Hessian."""
    return dp + dp * (dp + 1) // 2


@dataclasses.dataclass
class LargeBA:
    """The plan of one camera / landmark graph structure, on the graph's
    device: the observations sorted stably by camera, the ``slot_reduce``
    plans of every sum, the pose-unary and (pose, pose) batches, and the
    variable values of the graph it was built from."""

    kind: str  # the observation batch's factor kind
    loss: object
    pose_first: bool  # the observation batch's slots are (pose, landmark)
    pose_kind: str  # the cameras' manifold: "se3" or "bal_cam9"
    dp: int  # a camera's dof: 6 or 9
    C: int
    L: int
    M: int  # observations
    Mp: int  # M rounded up to a multiple of n_chunks: the chunk grid
    n_chunks: int
    poses: torch.Tensor  # (C, 4, 4) se3, or (C, 19) bal_cam9 [vec(T), f, k1, k2]
    lms: torch.Tensor  # (L, 3)
    free_p: torch.Tensor  # (C,) 1.0 free, 0.0 constant
    free_l: torch.Tensor  # (L,)
    obs_data: dict  # per-observation tensors in camera order; other values as given
    per_obs: frozenset  # the keys of obs_data that carry the observation axis
    weight: torch.Tensor  # (M,) in camera order
    cam_idx: torch.Tensor  # (M,) int64, ascending
    pt_idx: torch.Tensor  # (M,) int64
    by_cam: Segments  # the M observations by camera
    by_lm: Segments  # ... by landmark
    unary: tuple  # the pose-unary and (pose, pose) batches, in graph order
    by_pose_u: Segments  # their Hessian and gradient rows by pose
    pp_i: torch.Tensor  # (E,) the (pose, pose) factors, int64
    pp_j: torch.Tensor
    by_pp_i: Segments
    by_pp_j: Segments
    rows: torch.Tensor  # rows_of(dp) on the device: the linearization's row gather
    # the observations go through ``cuda_ops.bal_rows`` (a
    # ``reprojection_bal`` batch on se3 cameras or a ``reprojection_bal9``
    # one on bal_cam9 cameras, whose loss ``kernel_loss`` takes), else
    # through the factor kernel chunk by chunk
    bal: bool = False
    # co-observation pair tables of linear="dense" and precond="stale"
    # (build_dense_pairs); None until a solve first needs them
    pairs: "DensePairs | None" = None
    # same-cluster pair tables of precond="cluster" (build_cluster_pairs),
    # built for clusters of cpairs_G cameras
    cpairs: "DensePairs | None" = None
    cpairs_G: int = 0


def _ceil_to(x, m):
    return -(-x // m) * m


def _host_index(t, n, what):
    """A factor index tensor on the host (int64), checked against [0, n)."""
    i = t.detach().cpu().numpy().astype(np.int64)
    if len(i) and (i.min() < 0 or i.max() >= n):
        raise ValueError(f"{what}: index out of range [0, {n}) (min {i.min()}, max {i.max()})")
    return i


def _segments(dest, n_slots, device):
    sp = slot_plan(dest, n_slots)
    return Segments(torch.as_tensor(sp.perm, device=device), torch.as_tensor(sp.offsets, device=device), n_slots,
                    sp.longest)


@span("plan")
def prepare_large_ba(
    graph: FactorGraph,
    n_chunks: int = 16,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
) -> LargeBA:
    """Build the plan of ``graph`` on the host and put it on the graph's
    device.  The graph holds ``se3`` poses or 9-dof ``bal_cam9`` cameras,
    3-dof landmarks, exactly one observation batch (either slot order) and
    otherwise pose-unary and (pose, pose) batches."""
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    if pb.kind not in CAMERAS or lb.dof != 3:
        raise ValueError(
            f"{pose_name}/{lm_name} must be se3 poses or bal_cam9 cameras + 3-dof landmarks "
            f"(got {pb.kind!r} / {lb.dof}-dof); use solve_schur / "
            "solve_auto for other manifolds"
        )
    obs = [b for b in graph.batches if tuple(b.slots) in ((pose_name, lm_name), (lm_name, pose_name))]
    unary = [b for b in graph.batches if tuple(b.slots) in ((pose_name,), (pose_name, pose_name))]
    if len(obs) != 1 or len(unary) + 1 != len(graph.batches):
        raise ValueError(
            "schur_large supports one pose-landmark batch plus pose-unary and "
            "pose-pose (between) batches"
        )
    (fb,) = obs
    C, L, M = pb.n, lb.n, fb.n
    device, dtype = pb.values.device, pb.values.dtype
    pose_first = tuple(fb.slots) == (pose_name, lm_name)
    cam_t, pt_t = fb.indices if pose_first else fb.indices[::-1]
    cam = _host_index(cam_t, C, f"factor batch {fb.kind!r} slot {pose_name!r}")
    pt = _host_index(pt_t, L, f"factor batch {fb.kind!r} slot {lm_name!r}")

    # the observations in camera order (stable): the sums by camera read
    # their rows in order, and the gathers of the linearization walk the
    # cameras one after the other
    order_np = _stable_argsort(cam, C) if M else np.zeros(0, np.int64)
    cam_s, pt_s = cam[order_np], pt[order_np]
    order = torch.as_tensor(order_np.astype(np.int64), device=device)
    obs_data, per_obs = {}, set()
    for k, v in fb.data.items():
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == M:
            obs_data[k] = v[order].contiguous()
            per_obs.add(k)
        else:  # no observation axis: a camera, one sqrt_info for the batch
            obs_data[k] = v

    u_dest, pis, pjs = [], [], []
    for u in unary:
        idx = [_host_index(i, C, f"factor batch {u.kind!r} slot {pose_name!r}") for i in u.indices]
        u_dest += idx
        if len(idx) == 2:
            pis.append(idx[0])
            pjs.append(idx[1])

    def cat(arrays):
        return np.concatenate(arrays) if arrays else np.zeros(0, np.int64)

    pi, pj = cat(pis), cat(pjs)
    return LargeBA(
        kind=fb.kind, loss=fb.loss, pose_first=pose_first, pose_kind=pb.kind, dp=pb.dof, C=C, L=L, M=M,
        Mp=_ceil_to(M, n_chunks), n_chunks=n_chunks,
        poses=pb.values, lms=lb.values,
        free_p=(~pb.const_mask).to(dtype), free_l=(~lb.const_mask).to(dtype),
        obs_data=obs_data, per_obs=frozenset(per_obs), weight=fb.weight[order].contiguous(),
        cam_idx=torch.as_tensor(cam_s, device=device), pt_idx=torch.as_tensor(pt_s, device=device),
        by_cam=_segments(cam_s, C, device), by_lm=_segments(pt_s, L, device),
        unary=tuple(unary), by_pose_u=_segments(cat(u_dest), C, device),
        pp_i=torch.as_tensor(pi, device=device), pp_j=torch.as_tensor(pj, device=device),
        by_pp_i=_segments(pi, C, device), by_pp_j=_segments(pj, C, device),
        rows=torch.as_tensor(rows_of(pb.dof), device=device),
        bal=fb.kind == CAMERAS[pb.kind] and kernel_loss(fb.loss) is not None,
    )


def _from_upper(rows, n):
    """(N, n(n+1)/2) upper-triangle rows -> symmetric (N, n, n) blocks."""
    i, j = torch.triu_indices(n, n, device=rows.device)
    out = rows.new_zeros((rows.shape[0], n, n))
    out[:, i, j] = rows
    out[:, j, i] = rows  # the diagonal twice, the same value
    return out


# --------------------------------------------------------------------------
# Linearization
# --------------------------------------------------------------------------


def obs_chunks(kind, pose_first, data, per_obs, poses, lms, cam_idx, pt_idx, weight, loss, gather, chunk):
    """The cost (M,) of M observations of factor ``kind`` and, with
    ``gather`` (``rows_of(dp)`` on their device), their rows (M,
    len(gather)) in that order, else None: the factor kernel run ``chunk`` observations at a
    time (the chunk bounds the memory of the Jacobians).  ``data`` holds the
    factor's measurements, those named in ``per_obs`` along the observation
    axis; ``pose_first``: the kernel takes (pose, landmark), else the
    reverse.  The chunked linearization, and ``cuda_ops.bal_rows_plain``."""
    M = cam_idx.shape[0]
    cost = poses.new_empty(M)
    rows = None if gather is None else poses.new_empty((M, len(gather)))
    for lo in range(0, M, max(chunk, 1)):
        hi = min(lo + chunk, M)
        T, X = poses[cam_idx[lo:hi]], lms[pt_idx[lo:hi]]
        r, jacs = FACTOR_KERNELS[kind]({k: (v[lo:hi] if k in per_obs else v) for k, v in data.items()},
                                       *((T, X) if pose_first else (X, T)), compute_jacobians=gather is not None)
        cost[lo:hi] = (loss.loss(r) * weight[lo:hi, None]).sum(1)
        if gather is None:
            continue
        J = torch.cat(jacs if pose_first else jacs[::-1], -1)  # (n, m, dp + 3)
        w = loss.weight(r) * weight[lo:hi, None]
        rows[lo:hi] = torch.cat([_tmv(J, w * r), _jtwj(J, w, J).flatten(1)], 1)[:, gather]
    return cost, rows


def _unary(plan, poses, want_grad, dp=None):
    """chi2 of the pose-unary and (pose, pose) batches; with ``want_grad``
    also their Hessian blocks and gradient rows summed by pose, (C, dp, dp)
    and (C, dp), and the per-factor couplings PP (E, dp, dp); dp None: the
    plan's."""
    dp = plan.dp if dp is None else dp
    chi2 = poses.new_zeros(())
    rows, PPs = [], []
    for u in plan.unary:
        r, jacs = FACTOR_KERNELS[u.kind](u.data, *(poses[i] for i in u.indices), compute_jacobians=want_grad)
        chi2 = chi2 + torch.sum(u.loss.loss(r) * u.weight[:, None])
        if not want_grad:
            continue
        w = u.loss.weight(r) * u.weight[:, None]
        rows += [torch.cat([_tmv(J, w * r), _jtwj(J, w, J).reshape(-1, dp * dp)], 1) for J in jacs]
        if len(jacs) == 2:
            PPs.append(_jtwj(jacs[0], w, jacs[1]))
    if not want_grad:
        return chi2
    sums = plan.by_pose_u.sum(torch.cat(rows)) if rows else poses.new_zeros((plan.C, dp + dp * dp))
    PP = torch.cat(PPs) if PPs else poses.new_zeros((0, dp, dp))
    return chi2, sums[:, dp:].reshape(-1, dp, dp), sums[:, :dp], PP


def bal_rows_args(plan, poses, lms):
    """``cuda_ops.bal_rows``' tensor arguments for the observations of a
    ``reprojection_bal`` or ``reprojection_bal9`` plan at (poses, lms): the
    indices, measurements and weights in camera order, sqrt_info as one
    (2, 2) or one an observation; f, k1 and k2 each observation's, or None
    where the (C, 19) cameras carry them."""
    d = plan.obs_data
    info = d["sqrt_info"] if "sqrt_info" in plan.per_obs else d["sqrt_info"].reshape(2, 2)
    f, k1, k2 = (d["f"], d["k1"], d["k2"]) if plan.dp == 6 else (None, None, None)
    return poses, lms, plan.cam_idx, plan.pt_idx, d["obs"], f, k1, k2, info, plan.weight


def _obs_pass(plan, poses, lms, want_rows):
    """Every observation's cost (M,) and, with ``want_rows``, its rows
    (M, len(plan.rows)) in ``rows_of(plan.dp)`` order: one ``bal_rows`` launch where the plan says
    so, else the factor kernel chunk by chunk into full-length buffers."""
    chunk = plan.Mp // plan.n_chunks
    if plan.bal:
        return bal_rows(*bal_rows_args(plan, poses, lms), plan.loss, rows=want_rows, chunk=chunk)
    return obs_chunks(plan.kind, plan.pose_first, plan.obs_data, plan.per_obs, poses, lms, plan.cam_idx,
                      plan.pt_idx, plan.weight, plan.loss, plan.rows if want_rows else None, chunk)


def _obs_cost(plan, poses, lms):
    """The observations' chi2 at (poses, lms), without Jacobians."""
    return _obs_pass(plan, poses, lms, False)[0].sum()


def _cost(plan, poses, lms):
    """chi2 at (poses, lms) without Jacobians: the cost-only pass."""
    return _obs_cost(plan, poses, lms) + _unary(plan, poses, False)


@span("schur.linearize.rows")
def _obs_rows(plan, poses, lms):
    """Every observation's cost (M,) and rows in ``rows_of(plan.dp)`` order."""
    return _obs_pass(plan, poses, lms, True)


@span("schur.linearize.parts")
def _parts(plan, poses, cam, lm, rows):
    """The masked pieces ``schur._schur_reduce`` reads from the camera sums
    ``cam`` (C, ``camera_width(dp)``), the landmark sums ``lm`` (L, 9) and
    the rows W, with the pose-unary and (pose, pose) batches added: (their
    chi2, parts)."""
    dp, cw = plan.dp, camera_width(plan.dp)
    c_u, H_u, g_u, PP = _unary(plan, poses, True)
    Hpp, g_p, Hll, g_l, W, PP = mask_constants(
        plan, _from_upper(cam[:, dp:], dp) + H_u, -cam[:, :dp] - g_u, _from_upper(lm[:, 3:], 3), -lm[:, :3],
        rows[:, cw + 9:].reshape(plan.M, dp, 3), PP, plan.free_p, plan.free_l)
    return c_u, dict(Hpp=Hpp, g_p=g_p, Hll=Hll, g_l=g_l, W=W, PP=PP, plan=plan)


@span("schur.linearize")
def _linearize(plan, poses, lms):
    """The normal equations at (poses, lms): (chi2, parts), ``parts`` the
    pieces ``schur._schur_reduce`` reads (Hpp, g_p, Hll, g_l, W, PP and the
    plan), masked by ``schur.mask_constants``."""
    cost, rows = _obs_rows(plan, poses, lms)
    cw = camera_width(plan.dp)
    with span("schur.linearize.sums"):
        cam, lm = plan.by_cam.sum(rows[:, :cw]), plan.by_lm.sum(rows[:, cw:cw + 9])
    c_u, parts = _parts(plan, poses, cam, lm, rows)
    return cost.sum() + c_u, parts


# --------------------------------------------------------------------------
# The linear solve
# --------------------------------------------------------------------------


# The CG iterations of the most recent linear solves (0-dim tensors on the
# device until ``cg_iterations`` reads them).
_CG_ITERATIONS: collections.deque = collections.deque(maxlen=4096)

# The host reads the CG stop test before iterations 0, CG_READ_EVERY,
# 2 CG_READ_EVERY, ...; 0: never, and a linear solve runs to its budget,
# its iterate frozen from the iteration where the test fails.  Timed alone
# against a read every iteration on an H100 (``profile_port.py``, PERF.md):
# never reading was the fastest on config 6 and Venice-mini, whose solves
# all run to their budgets.
CG_READ_EVERY = 0


def reset_cg_iterations():
    _CG_ITERATIONS.clear()


def cg_iterations() -> list:
    """The CG iterations of each linear solve since ``reset_cg_iterations``
    (at most the last 4096), read from the device here."""
    return [int(n) for n in _CG_ITERATIONS]


@span("schur.pcg")
def _pcg(matvec, precond, b, rtol, max_iters, read_every=None, psum=None, guard=True):
    """PCG from x0 = 0, the reference's fused loop: stop when ||r||² <=
    rtol² ||b||² (tested before each iteration; NaN stops) or after
    ``max_iters`` iterations; where rz <= 0 or pAp <= 0 (exact convergence,
    breakdown) the iteration keeps r and p as they are; ``guard=False``
    drops that guard, as ``linear.pcg_solve`` and the reference's
    ``pcg_solve`` have none (a zero pAp gives a non-finite step, the test
    then stops the loop and the LM loop rejects the step).  The stop test is
    applied on the device (``torch.where`` keeps x, r and p once it has
    failed) and read by the host every ``read_every`` iterations, where the
    loop ends if it has failed (None: ``CG_READ_EVERY`` at the time of the
    call, which every solver that runs this loop takes).  ``psum``: for
    vectors split over ranks, each rank holding its rows
    (``dist/pose_sharded.py``), the sum over the ranks of a vector of dot
    products, so that every rank tests and scales by the same numbers.

    ``b`` is one right-hand side (n,) or a block (n, m): every column then
    runs these recurrences with its own dot products, stop test and count,
    frozen from the iteration its test fails (the reference's vmap of
    ``pcg_solve`` over the columns), and the host read ends the loop when
    no column runs.  Returns (x, iterations), the count a 0-dim or (m,)
    int64 tensor on b's device."""

    def dot(u, v):
        return torch.dot(u, v) if u.dim() == 1 else (u * v).sum(0)

    def dots(*pairs):
        if psum is None:
            return [dot(u, v) for u, v in pairs]
        return psum(torch.stack([dot(u, v) for u, v in pairs])).unbind()

    if read_every is None:
        read_every = CG_READ_EVERY
    x = torch.zeros_like(b)
    r, z = b, precond(b)
    rz, rn2 = dots((b, z), (b, b))
    p, tol2 = z, rtol**2 * rn2
    run = torch.ones(b.shape[1:], dtype=torch.bool, device=b.device)
    done = torch.zeros(b.shape[1:], dtype=torch.int64, device=b.device)
    for k in range(max_iters):
        run = run & (rn2 > tol2)
        if read_every and k % read_every == 0:
            HOST_READS["pcg"] += 1
            running = run.any()
            with span("read"):
                running = bool(running)
            if not running:
                break
        Ap = matvec(p)
        (pAp,) = dots((p, Ap))
        if guard:
            ok = (rz > 0.0) & (pAp > 0.0)
            step = run & ok
            alpha = torch.where(ok, rz / torch.where(ok, pAp, 1.0), 0.0)
        else:  # where the loop no longer runs, the selects below drop these values
            step, alpha = run, rz / pAp
        x = torch.where(run, x + alpha * p, x)
        r = torch.where(step, r - alpha * Ap, r)
        z = precond(r)
        rz_r, rn2 = dots((r, z), (r, r))
        rz_new = torch.where(step, rz_r, rz)
        beta = torch.where(ok, rz_new / torch.where(ok, rz, 1.0), 0.0) if guard else rz_new / rz
        p = torch.where(step, z + beta * p, p)
        rz = rz_new
        done = done + run
    return x, done


@span("schur.reduce")
def _reduce(parts, lam, method, cam_sum=None):
    """``schur._schur_reduce`` (LM damping, Hll⁻¹, the reduced gradient)
    and the exact block diagonal D of S: (Hll_inv, g_red, D, damped Hpp).
    ``cam_sum`` as in ``schur._schur_reduce``."""
    Hpp, Hll_inv, W, g_red = _schur_reduce(parts, lam, method, cam_sum)
    return Hll_inv, g_red, schur_block_diag(parts["plan"], Hpp, Hll_inv, W, cam_sum), Hpp


def _solve_pcg(parts, lam, method, rtol, max_iters, cam_sum=None, make_precond=None):
    """PCG on S dx = g_red under the block inverse of D, or under
    ``make_precond(parts, Hll_inv, D)`` where given (the cluster and stale-S
    preconditioners); ``cam_sum`` as in ``schur._schur_reduce``
    (``dist/schur_reduce.py`` sums over the ranks there)."""
    Hll_inv, g_red, D, Hpp = _reduce(parts, lam, method, cam_sum)
    matvec = schur_matvec(parts["plan"], Hpp, Hll_inv, parts["W"], parts["PP"], cam_sum)
    precond = block_jacobi(_binv(_cholesky(D))) if make_precond is None else make_precond(parts, Hll_inv, D)
    x, it = _pcg(matvec, precond, g_red.reshape(-1), rtol, max_iters)
    _CG_ITERATIONS.append(it)
    return Hll_inv, x


@span("schur.back_substitute")
def _back_substitute_retract(parts, Hll_inv, poses, lms, x):
    """dx_l = Hll⁻¹ (g_l - Wᵀ dx_p) (``schur._back_substitute``; a constant
    or dead landmark's row is 0, as the masks leave it), the retraction and
    the reference's update norm."""
    plan = parts["plan"]
    dx_p = x.reshape(plan.C, plan.dp) * plan.free_p[:, None]
    dx_l = _back_substitute(Hll_inv, parts["W"], plan, parts["g_l"], dx_p)
    dx_norm = torch.sqrt(torch.sum(dx_p**2) + torch.sum(dx_l**2))
    return (retract(plan.pose_kind, poses, dx_p), lms + dx_l), dx_norm


# --------------------------------------------------------------------------
# linear="dense": S assembled from the co-observation pairs
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DensePairs:
    """Co-observation pair tables of the dense-S solve.

    One row per unordered pair of observations (a, b), a != b, of one
    landmark, oriented so that camera(a) <= camera(b); a and b index the
    plan's camera-ordered observations.
    ``by_block`` sums the dp² entries of every contribution to a block of
    S above the diagonal or on it — the P pair products, then half of each
    camera's diagonal block, then each (pose, pose) coupling — into the
    unique blocks (``block_i``, ``block_j``).  Host-built once per
    observation pattern."""

    P: int
    n_pair_chunks: int
    pair_a: torch.Tensor  # (P,) int64
    pair_b: torch.Tensor
    block_i: torch.Tensor  # (U,) int64
    block_j: torch.Tensor
    by_block: Segments
    # the (pose, pose) couplings ``by_block`` sums, as rows of PP (None: all)
    pp_rows: torch.Tensor | None = None


def build_dense_pairs(plan: LargeBA, n_pair_chunks: int = 4) -> DensePairs:
    """Enumerate the co-observation pairs of ``plan``'s graph on the host
    (``schur_sparse._coobservation_pairs``) and the plan of their sum into
    the blocks of S."""
    from .schur_sparse import _coobservation_pairs

    C = plan.C
    ci = plan.cam_idx.cpu().numpy()
    li = plan.pt_idx.cpu().numpy()
    pa, pb, _ = _coobservation_pairs(ci, li, plan.L)
    keep = pa < pb  # one row per unordered pair; symmetrization restores (b, a)
    pa, pb = pa[keep].astype(np.int64), pb[keep].astype(np.int64)
    i, j = ci[pa], ci[pb]
    swap = i > j
    pa, pb = np.where(swap, pb, pa), np.where(swap, pa, pb)
    q = np.minimum(i, j) * C + np.maximum(i, j)
    cams = np.arange(C, dtype=np.int64)
    pp_q = plan.pp_i.cpu().numpy() * C + plan.pp_j.cpu().numpy()
    keys = np.concatenate([q, cams * (C + 1), pp_q])
    uniq, dest = np.unique(keys, return_inverse=True)
    device = plan.cam_idx.device

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)

    return DensePairs(
        P=len(pa), n_pair_chunks=n_pair_chunks, pair_a=t(pa), pair_b=t(pb),
        block_i=t(uniq // C), block_j=t(uniq % C), by_block=_segments(dest.reshape(-1), len(uniq), device),
    )


def build_cluster_pairs(plan: LargeBA, cluster: int, n_pair_chunks: int = 4) -> DensePairs:
    """The same-cluster subset of the co-observation pairs, for the cluster
    block-Jacobi preconditioner: pairs (a, b) with cam(a) // cluster ==
    cam(b) // cluster, in the reference's order and orientation, and the
    plan of the sum of their products, of half of every camera's diagonal
    block (a unit block for each camera past C in the last cluster) and of
    the same-cluster (pose, pose) couplings into the unique blocks of the
    K = ceil(C / cluster) diagonal (dp cluster, dp cluster) blocks of S.
    ``block_i`` / ``block_j`` name a block by its two cameras, counted over
    K * cluster (the reference buckets it as cid * cluster² + la * cluster +
    lb)."""
    from .schur_sparse import _coobservation_pairs

    C, G = plan.C, int(cluster)
    if G < 1:
        raise ValueError(f"cluster_size must be at least 1, got {cluster}")
    ci = plan.cam_idx.cpu().numpy()
    li = plan.pt_idx.cpu().numpy()
    pa, pb, _ = _coobservation_pairs(ci, li, plan.L)
    keep = pa < pb
    pa, pb = pa[keep].astype(np.int64), pb[keep].astype(np.int64)
    i, j = ci[pa], ci[pb]
    same = (i // G) == (j // G)
    pa, pb, i, j = pa[same], pb[same], i[same], j[same]
    swap = i > j
    pa, pb = np.where(swap, pb, pa), np.where(swap, pa, pb)
    ii, jj = np.minimum(i, j), np.maximum(i, j)
    Cp = -(-C // G) * G
    cams = np.arange(Cp, dtype=np.int64)
    pi, pj = plan.pp_i.cpu().numpy(), plan.pp_j.cpu().numpy()
    pp_rows = np.flatnonzero((pi // G) == (pj // G))
    # a block as its two padded cameras: ii * Cp + jj
    keys = np.concatenate([ii * Cp + jj, cams * (Cp + 1), pi[pp_rows] * Cp + pj[pp_rows]])
    uniq, dest = np.unique(keys, return_inverse=True)
    device = plan.cam_idx.device

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)

    return DensePairs(
        P=len(pa), n_pair_chunks=n_pair_chunks, pair_a=t(pa), pair_b=t(pb), block_i=t(uniq // Cp),
        block_j=t(uniq % Cp), by_block=_segments(dest.reshape(-1), len(uniq), device), pp_rows=t(pp_rows),
    )


def _pair_blocks(pairs, W, Hll_inv, li):
    """-(W_a Hll⁻¹ W_bᵀ) of every pair, (P, dp²), in ``n_pair_chunks``
    chunks (the chunk bounds the gathered blocks' memory)."""
    blocks = W.new_empty((pairs.P, W.shape[1] ** 2))
    chunk = max(-(-pairs.P // max(pairs.n_pair_chunks, 1)), 1)
    for lo in range(0, pairs.P, chunk):
        a, b = pairs.pair_a[lo:lo + chunk], pairs.pair_b[lo:lo + chunk]
        blocks[lo:lo + chunk] = -_mm(_mm(W[a], Hll_inv[li[a]]), W[b].transpose(-1, -2)).flatten(1)
    return blocks


def _equilibrated_cholesky(S):
    """(L, s): the lower Cholesky factor of S scaled by s = diag(S)^-1/2 on
    both sides (NaN where it fails), over the last two axes."""
    s = torch.rsqrt(torch.clamp(torch.diagonal(S, dim1=-2, dim2=-1), min=1e-30))
    return _cholesky(S * s[..., :, None] * s[..., None, :]), s


def _factor_apply(L, s, r):
    """(s L⁻ᵀ L⁻¹ s) r for factors (..., n, n) and r (..., n)."""
    y = torch.linalg.solve_triangular(L, (r * s)[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0] * s


def _cluster_precond(cpairs, G, parts, Hll_inv, D):
    """The cluster block-Jacobi preconditioner r -> M⁻¹ r: the (dp G, dp G)
    diagonal blocks of S from the same-cluster pairs (one ``slot_reduce``
    into their unique blocks, D at half weight, the same-cluster
    couplings), symmetrized, Jacobi-equilibrated and factored by one batched
    Cholesky; applied by batched triangular solves."""
    plan, W, PP = parts["plan"], parts["W"], parts["PP"]
    C, dp = plan.C, plan.dp
    K = -(-C // G)
    Cp = K * G
    Dp = D.reshape(C, dp * dp)
    if Cp > C:  # the padded cameras of the last cluster: unit blocks, decoupled
        eye = torch.eye(dp, dtype=D.dtype, device=D.device).reshape(1, dp * dp)
        Dp = torch.cat([Dp, eye.expand(Cp - C, dp * dp)])
    rows = [_pair_blocks(cpairs, W, Hll_inv, plan.pt_idx), 0.5 * Dp, PP[cpairs.pp_rows].flatten(1)]
    sums = cpairs.by_block.sum(torch.cat(rows))
    S = W.new_zeros((K, G, G, dp, dp))
    S[cpairs.block_i // G, cpairs.block_i % G, cpairs.block_j % G] = sums.reshape(-1, dp, dp)  # unique blocks
    S = S.transpose(2, 3).reshape(K, dp * G, dp * G)
    L, s = _equilibrated_cholesky(S + S.transpose(1, 2))

    def precond(r):
        rp = torch.cat([r.reshape(C, dp), r.new_zeros((Cp - C, dp))]).reshape(K, dp * G)
        return _factor_apply(L, s, rp).reshape(Cp, dp)[:C].reshape(-1)

    return precond


def _dense_S(pairs, parts, Hll_inv, D):
    """The reduced camera system S (dp C, dp C) = D - sym(Σ_pairs W_a
    Hll⁻¹ W_bᵀ) + couplings: D at half weight and the pair products summed
    into unique blocks above the diagonal, then S_pre + S_preᵀ."""
    plan, W, PP = parts["plan"], parts["W"], parts["PP"]
    C, dp = plan.C, plan.dp
    blocks = _pair_blocks(pairs, W, Hll_inv, plan.pt_idx)
    sums = pairs.by_block.sum(torch.cat([blocks, 0.5 * D.reshape(C, dp * dp), PP.flatten(1)]))
    S = W.new_zeros((C, C, dp, dp))
    S[pairs.block_i, pairs.block_j] = sums.reshape(-1, dp, dp)  # unique blocks
    S = S.transpose(1, 2).reshape(dp * C, dp * C)
    return S + S.T


def _solve_dense(pairs, parts, lam, method):
    """The exact solve of S dx = g_red: Jacobi equilibration to a unit
    diagonal, Cholesky (NaN where it fails) and two triangular solves."""
    Hll_inv, g_red, D, _ = _reduce(parts, lam, method)
    S = _dense_S(pairs, parts, Hll_inv, D)
    s = torch.rsqrt(torch.clamp(torch.diagonal(S), min=1e-30))
    x = cholesky_solve(S * s[:, None] * s[None, :], g_red.reshape(-1) * s)
    return Hll_inv, x * s


def _stale_factor(pairs, parts, Hll_inv, D):
    """(L, s): the equilibrated Cholesky factor of this solve's dense S
    (``_dense_S``), kept as the preconditioner of the next solves."""
    return _equilibrated_cholesky(_dense_S(pairs, parts, Hll_inv, D))


# --------------------------------------------------------------------------
# The solve
# --------------------------------------------------------------------------


@span("solve")
def solve_schur_large(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    n_chunks: int = 16,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    pcg_rtol: float = 1e-4,
    pcg_max_iters: int = 30,
    speculative: bool = True,
    dual_order: bool = True,
    plan: "LargeBA | None" = None,
    linear: str = "pcg",
    n_pair_chunks: int = 4,
    precond: str = "jacobi",
    cluster_size: int = 64,
    stale_refresh: int = 3,
):
    """Venice-scale Schur LM on one device.  Returns (solved_graph,
    final_chi2, cost_history): the last accepted cost and the accepted
    costs, initial cost first, as Python floats.

    ``plan``: a prebuilt ``prepare_large_ba(graph, n_chunks)`` to reuse
    across solves of the same graph structure; it carries the variable
    values of the graph it was built from, so pass a plan built from this
    same graph.

    ``linear="pcg"`` solves the reduced camera system by PCG from x0 = 0
    under its exact block diagonal (``pcg_rtol``, ``pcg_max_iters``);
    ``linear="dense"`` assembles S from the co-observation pairs (built on
    the plan once) and factors it.  ``speculative=True`` runs
    ``host_lm_loop_speculative`` (one gradient linearization an
    iteration), else ``host_lm_loop`` with a cost-only pass at each trial.

    ``dual_order`` is the reference's TPU layout switch (a landmark-ordered
    copy of W for its cumsum sums); here every sum goes through one
    ``slot_reduce`` plan, so it has no effect.

    ``precond`` (PCG only; with ``linear="dense"`` the reference ignores it
    and so does this): ``"jacobi"``, the exact dp x dp block diagonal of S
    (dp the cameras' dof, 6 or 9); ``"cluster"``, the dense (dp G, dp G)
    diagonal blocks of S over clusters of
    G = ``cluster_size`` consecutive cameras, assembled each linear solve
    from the same-cluster co-observation pairs (``build_cluster_pairs``,
    built once and kept on the plan) and factored by one batched Cholesky;
    ``"stale"``, the equilibrated Cholesky factor of the dense S
    (``build_dense_pairs``, kept on the plan) of one linear solve,
    refactored every ``stale_refresh`` linear solves (rejected LM steps
    count) and applied in between by two triangular solves.  Both take at
    most 60 CG iterations, as in the reference, checked before any pair
    table is built."""
    lb = plan if plan is not None else prepare_large_ba(graph, n_chunks, pose_name, lm_name)
    if linear not in ("pcg", "dense"):
        raise ValueError(f"linear must be 'pcg' or 'dense', got {linear!r}")
    if precond not in ("jacobi", "cluster", "stale"):
        raise ValueError(f"precond must be 'jacobi', 'cluster' or 'stale', got {precond!r}")
    if linear == "pcg" and precond in ("cluster", "stale") and pcg_max_iters > 60:
        # checked before the pair tables below are built
        raise ValueError(f"precond={precond!r} runs in the fused PCG path only (pcg_max_iters <= 60)")
    pairs = None
    if linear == "dense" or (linear == "pcg" and precond == "stale"):
        if lb.pairs is None or lb.pairs.n_pair_chunks != n_pair_chunks:
            lb.pairs = build_dense_pairs(lb, n_pair_chunks)
        pairs = lb.pairs
    make_precond = None
    if linear == "pcg" and precond == "cluster":
        if lb.cpairs is None or lb.cpairs_G != cluster_size or lb.cpairs.n_pair_chunks != n_pair_chunks:
            lb.cpairs = build_cluster_pairs(lb, cluster_size, n_pair_chunks)
            lb.cpairs_G = cluster_size
        cpairs = lb.cpairs

        make_precond = functools.partial(_cluster_precond, cpairs, cluster_size)

    elif linear == "pcg" and precond == "stale":
        stale = {"fac": None, "age": 0}

        def make_precond(parts, Hll_inv, D):
            if stale["fac"] is None or stale["age"] >= stale_refresh:
                stale["fac"] = _stale_factor(pairs, parts, Hll_inv, D)
                stale["age"] = 0
            stale["age"] += 1
            L, s = stale["fac"]
            return functools.partial(_factor_apply, L, s)

    def linearize(state):
        return _linearize(lb, *state)

    def solve_from(state, lin, lam):
        parts = lin[1]
        if linear == "dense":
            Hll_inv, x = _solve_dense(pairs, parts, lam, options.method)
        else:
            Hll_inv, x = _solve_pcg(parts, lam, options.method, pcg_rtol, pcg_max_iters, make_precond=make_precond)
        return _back_substitute_retract(parts, Hll_inv, *state, x)

    if speculative:
        (poses, lms), history, _ = host_lm_loop_speculative(linearize, solve_from, (lb.poses, lb.lms), options)
    else:

        def lm_step(state, lam):
            lin = linearize(state)
            trial, dx_norm = solve_from(state, lin, lam)
            chi2 = lin[0]
            del lin
            return trial, chi2, _cost(lb, *trial), dx_norm

        (poses, lms), history, _ = host_lm_loop(lm_step, (lb.poses, lb.lms), options)

    pb, lb_blk = graph.blocks[pose_name], graph.blocks[lm_name]
    new_blocks = dict(graph.blocks)
    new_blocks[pose_name] = VariableBlock(pb.kind, poses, pb.const_mask)
    new_blocks[lm_name] = VariableBlock(lb_blk.kind, lms, lb_blk.const_mask)
    return FactorGraph(new_blocks, graph.batches), history[-1], history


__all__ = [
    "solve_schur_large",
    "prepare_large_ba",
    "build_dense_pairs",
    "build_cluster_pairs",
    "DensePairs",
    "LargeBA",
]
