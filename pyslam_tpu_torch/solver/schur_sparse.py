"""SPARSE_SCHUR: exact sparse direct solves of the reduced camera system.

Counterpart of ``pyslam_tpu/solver/schur_sparse.py``, the third Schur
flavor beside ``solve_schur``'s 'dense' and 'pcg' modes.  After landmark
elimination the reduced system

    S = Hpp + PP_couplings - W Hll^-1 W^T

is block-sparse, with one off-diagonal block per pose pair that shares a
(pose, pose) factor or CO-OBSERVES a landmark.  For many-poses /
few-landmarks graphs (2D landmark SLAM, sliding windows, sparse-visibility
BA) that camera graph is nearly as sparse as a pose graph, so S factors
exactly through the multifrontal block Cholesky (``sparse_chol.py``) at
O(fill).

The host enumerates, once per sparsity pattern, every ordered
co-observation pair (obs_a, obs_b of the same landmark) and its flat
position in the symmetric-ELL store of S, plus the nested-dissection
plan.  The observations are taken in the order ``ba_assemble`` stacks W
(``schur.schur_host_tables``), in either slot order of an observation
batch.  The device, per LM iteration, computes all pair blocks W_a Hll^-1
W_b^T in one batched product and sums them, with Hpp and the (pose, pose)
couplings, into the ELL slots of S by one ``slot_reduce`` over a plan
sorted once on the host (the reference's ``segment_sum``); then the
multifrontal factorization.  The pair enumeration is exact under duplicate
observations too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.core import FactorBatch, FactorGraph
from . import lm as _lm
from .cuda_ops import slot_plan, slot_reduce
from .plan_cache import ClosureCache, content_key
from .schur import _back_substitute, _concat_dx, _mm, _schur_reduce, ba_assemble, schur_host_tables, schur_plan
from .sparse_chol import CholPlan, _device_waves, _factorize, _solve_factored, build_chol_plan


@dataclasses.dataclass
class SchurSparsePlan:
    """Host-side pair tables + multifrontal plan for the reduced system."""

    chol: CholPlan
    C: int
    dp: int
    pair_a: np.ndarray  # (P,) observation index (into ba_assemble's W)
    pair_b: np.ndarray  # (P,)
    pair_l: np.ndarray  # (P,) landmark index
    pair_pos: np.ndarray  # (P,) flat ELL position of (cam_a, cam_b)
    diag_pos: np.ndarray  # (C,) flat ELL positions of the diagonal
    pp_pos_ab: np.ndarray  # (E,) between-coupling positions
    pp_pos_ba: np.ndarray  # (E,)
    n_pairs: int
    n_edges: int  # unique off-diagonal S edges (both directions)


def _coobservation_pairs(ci: np.ndarray, li: np.ndarray, L: int):
    """All ordered pairs (a, b) of observations sharing a landmark,
    vectorized (no per-landmark Python loop)."""
    order = np.argsort(li, kind="stable")
    li_s = li[order]
    counts = np.bincount(li_s, minlength=L)
    nz = np.flatnonzero(counts)
    c = counts[nz]
    seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])[nz]
    P_l = c * c
    total = int(P_l.sum())
    # within-pair rank for every pair, segmented per landmark
    pair_seg = np.repeat(np.arange(len(nz)), P_l)
    offs = np.concatenate([[0], np.cumsum(P_l)[:-1]])
    within = np.arange(total) - offs[pair_seg]
    cs = c[pair_seg]
    a_rank = within // cs
    b_rank = within % cs
    base = seg_start[pair_seg]
    pair_a = order[base + a_rank]
    pair_b = order[base + b_rank]
    pair_lm = nz[pair_seg]
    return pair_a, pair_b, pair_lm


def _observed_landmarks(graph: FactorGraph, pose_name: str, lm_name: str) -> np.ndarray:
    """The landmark of every observation, both slot orders (host)."""
    lis = []
    for fb in graph.batches:
        if tuple(fb.slots) in ((pose_name, lm_name), (lm_name, pose_name)):
            i = fb.indices[1] if fb.slots[1] == lm_name else fb.indices[0]
            lis.append(i.detach().cpu().numpy().astype(np.int64))
    return np.concatenate(lis) if lis else np.zeros(0, np.int64)


def coobservation_stats(graph: FactorGraph, pose_name="poses", lm_name="landmarks"):
    """Cheap host gate for route_auto: (sum of squared landmark degrees =
    pair count, upper bound on S edges) without enumerating pairs.  Reads
    the observations' landmark indices to the host."""
    lb = graph.blocks[lm_name]
    deg = np.bincount(_observed_landmarks(graph, pose_name, lm_name), minlength=max(lb.n, 1))
    return int((deg.astype(np.int64) ** 2).sum()), int(deg.max() if len(deg) else 0)


def build_schur_sparse_plan(
    graph: FactorGraph,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    leaf_size: int = 32,
) -> SchurSparsePlan:
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    C, dp, L = pb.n, pb.dof, lb.n

    # observation / (pose, pose) indices in ba_assemble's stacking order
    host = schur_host_tables(graph, pose_name, lm_name)
    ci, li, pp_i, pp_j = host["cam"], host["pt"], host["pi"], host["pj"]
    pair_a, pair_b, pair_lm = _coobservation_pairs(ci, li, L)

    # structure-only pose graph carrying the S sparsity: (pose, pose) edges
    # + co-observation edges.  build_ell_direct reads only the slots and
    # indices of its batches (the kinds are never looked up), and its maps
    # hand back the flat ELL position of every (slot_a, slot_b) index pair:
    # exactly the lookup the device assembly needs (diagonal pairs map to
    # slot 0).
    def structure(kind, i, j):
        i, j = torch.as_tensor(i, dtype=torch.int64), torch.as_tensor(j, dtype=torch.int64)
        return FactorBatch(kind, (pose_name, pose_name), (i, j), {}, None, torch.ones(len(i), dtype=torch.float64))

    dummy = FactorGraph(
        {pose_name: pb},
        [structure("structure_pp", pp_i, pp_j), structure("structure_coobs", ci[pair_a], ci[pair_b])],
    )
    chol = build_chol_plan(dummy, pose_name, leaf_size=leaf_size)
    ell = chol.ell  # the SAME store the factorization gathers from

    # maps[batch] has one entry per slot pair (0,0), (0,1), (1,1); the
    # (0,1) entry carries (slot_a, slot_b, flat_pos_ab, flat_pos_ba)
    _, _, pp_ab, pp_ba = ell.maps[0][1]
    _, _, pair_ab, _ = ell.maps[1][1]
    diag_pos = np.arange(C, dtype=np.int64) * ell.K
    n_edges = int(ell.valid.sum() - C)

    return SchurSparsePlan(
        chol=chol, C=C, dp=dp,
        pair_a=pair_a, pair_b=pair_b, pair_l=pair_lm,
        pair_pos=np.asarray(pair_ab),
        diag_pos=diag_pos,
        pp_pos_ab=np.asarray(pp_ab), pp_pos_ba=np.asarray(pp_ba),
        n_pairs=len(pair_a), n_edges=n_edges,
    )


@dataclasses.dataclass(frozen=True)
class SchurSparseTables:
    """A plan's tables on one device: the pair indices (int64) and the
    ``slot_reduce`` plan (int32) of the contributions [Hpp, PP, PP^T, -pair
    blocks] into the nb * K slots of S's ELL store."""

    pair_a: torch.Tensor
    pair_b: torch.Tensor
    pair_l: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    n_slots: int
    longest: int | None = None  # the plan's longest segment (``slot_reduce``'s ``longest``)


def plan_tables(plan: SchurSparsePlan, device) -> SchurSparseTables:
    """The plan's device tables, built once per plan and device and kept on
    the plan object."""
    device = torch.device(device)
    cache = plan.__dict__.setdefault("_tables", {})
    if device not in cache:
        n_slots = plan.chol.ell.nb * plan.chol.ell.K
        dest = np.concatenate([plan.diag_pos, plan.pp_pos_ab, plan.pp_pos_ba, plan.pair_pos]).astype(np.int64)
        sp = slot_plan(dest, n_slots)

        def t(a, dtype=np.int64):
            return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

        cache[device] = SchurSparseTables(
            t(plan.pair_a), t(plan.pair_b), t(plan.pair_l), t(sp.perm, np.int32), t(sp.offsets, np.int32), n_slots,
            sp.longest)
    return cache[device]


def assemble_S_ell(plan: SchurSparsePlan, tables: SchurSparseTables, Hpp, PP, W, Hll_inv):
    """S = Hpp + PP couplings - W Hll^-1 W^T into the symmetric-ELL store:
    one batched product over the co-observation pairs + one ``slot_reduce``."""
    dp = Hpp.shape[1]
    Cp = _mm(_mm(W[tables.pair_a], Hll_inv[tables.pair_l]), W[tables.pair_b].transpose(-1, -2))
    contrib = torch.cat([Hpp, PP, PP.transpose(-1, -2), -Cp]).reshape(-1, dp * dp)
    He = slot_reduce(contrib, tables.perm, tables.offsets, tables.n_slots, tables.longest)
    return He.reshape(plan.chol.ell.nb, plan.chol.ell.K, dp, dp)


def schur_solve_sparse(parts, g, lam, opt: _lm.Options, plan: SchurSparsePlan, tables: SchurSparseTables):
    """One exact SPARSE_SCHUR linear solve."""
    Hpp, Hll_inv, W, g_red = _schur_reduce(parts, lam, opt.method)
    C, dp = Hpp.shape[0], Hpp.shape[1]
    He = assemble_S_ell(plan, tables, Hpp, parts["PP"], W, Hll_inv)
    # damping already applied to Hpp/Hll by _schur_reduce; factor directly
    factors = _factorize(plan.chol, He)
    dx_p = _solve_factored(plan.chol, factors, g_red.reshape(-1)).reshape(C, dp)
    dx_l = _back_substitute(Hll_inv, W, parts["plan"], parts["g_l"], dx_p)
    return _concat_dx(parts, dx_p, dx_l)


_PLANS = ClosureCache()


def solve_schur_sparse(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    plan: SchurSparsePlan | None = None,
    leaf_size: int = 32,
):
    """GN/LM with EXACT sparse direct solves of the Schur-reduced camera
    system.  Same dx as ``solve_schur(mode='dense')`` in exact arithmetic;
    O(S-fill) memory instead of (C*dp)^2.  Right for many-poses /
    few-landmarks graphs whose co-observation structure is sparse.
    Returns (solved_graph, SolveInfo)."""
    if plan is None:
        # content-keyed plan reuse: repeated solves over the same sparsity
        # skip the host pair enumeration and the nested dissection
        pkey = (
            "plan", pose_name, lm_name, leaf_size, graph.blocks[pose_name].n, graph.blocks[lm_name].n,
            tuple((tuple(fb.slots), tuple(content_key(i) for i in fb.indices)) for fb in graph.batches),
        )
        if pkey not in _PLANS:
            _PLANS[pkey] = build_schur_sparse_plan(graph, pose_name, lm_name, leaf_size)
        plan = _PLANS[pkey]
    device = graph.blocks[pose_name].values.device
    splan = schur_plan(graph, pose_name, lm_name)
    tables = plan_tables(plan, device)
    _device_waves(plan.chol, device)

    def assemble_fn(g):
        return ba_assemble(g, pose_name, lm_name, splan)

    def solve_fn(parts, g, lam, opt):
        return schur_solve_sparse(parts, g, lam, opt, plan, tables)

    return _lm.solve(graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn)


__all__ = [
    "SchurSparsePlan",
    "SchurSparseTables",
    "assemble_S_ell",
    "build_schur_sparse_plan",
    "coobservation_stats",
    "plan_tables",
    "schur_solve_sparse",
    "solve_schur_sparse",
]
