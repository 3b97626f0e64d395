"""Sparse direct block Cholesky: supernodal multifrontal factorization.

Counterpart of ``pyslam_tpu/solver/sparse_chol.py``: the exact linear
solve for graphs beyond the dense ceiling (stiff 2-D pose graphs, where
PCG stalls in a worse basin, and the reduced camera system of
``schur_sparse``), at O(fill) memory instead of O(D^2).

The sparsity lives on the host, the arithmetic on the device:

  * Host (numpy, once per sparsity pattern), copied from the reference:
    recursive BFS nested dissection builds a binary elimination tree whose
    leaf interiors and separators are the supernodes.  A symbolic pass
    gives each node its frontal variables (eliminated columns + boundary)
    and compiles three gather tables per wave of nodes of equal height
    (``tbl_orig`` into the ELL store of H, ``tbl_l`` / ``tbl_r`` into the
    update pool of the left / right child), so the multifrontal
    extend-add is two gathers, not a scatter.  Within a wave, nodes are
    bucketed by geometrically padded (k, b) sizes so that padding stays
    small.
  * Device (per LM iteration), batched over the nodes of a wave: gather
    the frontals, one batched ``cholesky_ex`` of the eliminated block (a
    failed node gives NaN blocks, no host read), one batched triangular
    solve for the boundary panel, one batched product for the update
    matrix, written into the pool as a contiguous slice.
  * Solves: level-scheduled batched triangular solves, forward over the
    waves deepest first, backward in reverse.  The forward solve's
    right-hand-side update adds each node's boundary contribution into
    variables that other nodes of the wave share, the reference's
    ``bvec.at[bi].add``: here one ``slot_reduce`` per wave over a plan sorted
    on the host (``_device_waves``), then one write per variable, so two
    runs give the same bits.  The backward solve writes each eliminated
    variable once.

  * The solves take one right-hand side (nb*d,) or a block (nb*d, m): the
    forward solve's rows are then d*m wide, with the same plans.

Uncertainty over the same factors: ``selected_inverse_marginals`` (the
Takahashi sweep, every diagonal block of H^-1 and the requested in-fill
cross blocks in one pass over the waves in reverse), ``locate_fill_pairs``
(host) and ``factor_logdet``.  The sweep hands each node's boundary
covariance to its children through the tables the factorization gathered
their updates with; apart from the zero block 0, no pool position is named
twice by the tables of a wave (each child-update entry is gathered by one
position of one parent front), so the hand-down is a plain indexed copy
over positions filtered on the host, checked unique when the first sweep
over a plan takes its tables to the device (``_sigma_scatters``).

Exactness: block Gaussian elimination in a fill-reducing order; in exact
arithmetic dx equals the dense Cholesky solution.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..graph.core import FactorGraph
from . import lm as _lm
from .bcsr import EllDirect, assemble_ell, build_ell_direct, ell_device_plan
from .cuda_ops import slot_plan, slot_reduce
from .plan_cache import ClosureCache, content_key
from .schur import _cholesky

# --------------------------------------------------------------------------
# Host-side: nested dissection + symbolic factorization (numpy, as in the
# reference)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CholPlan:
    """Static multifrontal plan over a single variable block."""

    nb: int
    d: int
    K: int  # ELL slot count of the source store
    ell: EllDirect
    # per wave (deepest first), each a tuple of numpy arrays:
    #   kpad, bpad, N,
    #   cols_idx (N, kpad) int32  var ids, pad -> nb
    #   bnd_idx  (N, bpad) int32  var ids, pad -> nb
    #   col_pad  (N, kpad) f64    1.0 where pad (unit diagonal)
    #   tbl_orig (N, f, f) int32  1 + flat ELL pos, 0 = zero block
    #   tbl_l / tbl_r (N, f, f) int32  1 + flat global-pool pos, 0 = zero
    waves: tuple
    pool_total: int = 0


def _csr_from_ell(ell: EllDirect):
    """CSR (indptr, indices) of the block adjacency (no self loops)."""
    nb, K = ell.nb, ell.K
    valid = ell.valid[:, 1:] > 0
    cols = ell.cols[:, 1:]
    counts = valid.sum(axis=1).astype(np.int64)
    indptr = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = cols[valid].astype(np.int64)
    return indptr, indices


def _neighbors_of(indptr, indices, verts):
    """Concatenated neighbor lists of ``verts`` — vectorized multi-slice
    gather (no python per-vertex loop; plans must build fast at 50k+)."""
    cnt = indptr[verts + 1] - indptr[verts]
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(0, np.int64), cnt
    ends = np.cumsum(cnt)
    pos = np.repeat(indptr[verts] - (ends - cnt), cnt) + np.arange(total)
    return indices[pos], cnt


def _bfs_levels(indptr, indices, verts, start, inset):
    """BFS level of every vertex in ``verts`` (vectorized frontier sweep).
    ``inset`` is a scratch bool mask with inset[verts] True.  Unreached
    vertices (disconnected) get level -1."""
    level = np.full(len(inset), -1, np.int64)
    frontier = np.asarray(start, np.int64).reshape(-1)
    level[frontier] = 0
    cur = 0
    while len(frontier):
        nbrs, _ = _neighbors_of(indptr, indices, frontier)
        nxt = np.unique(nbrs)
        nxt = nxt[inset[nxt] & (level[nxt] < 0)]
        cur += 1
        level[nxt] = cur
        frontier = nxt
    return level


def _bisect(indptr, indices, verts, inset):
    """Split ``verts`` into (A, B, S): S ⊂ old B side, no edges A <-> B."""
    # pseudo-peripheral start: BFS twice
    lev = _bfs_levels(indptr, indices, verts, verts[0], inset)
    lv = lev[verts]
    far = verts[np.argmax(np.where(lv >= 0, lv, -1))]
    lev = _bfs_levels(indptr, indices, verts, far, inset)
    lv = lev[verts]
    # disconnected part joins the far side
    maxlev = lv.max()
    lv = np.where(lv < 0, maxlev + 1, lv)
    order = np.argsort(lv, kind="stable")
    half = len(verts) // 2
    # split at the level boundary nearest the vertex median
    t = lv[order[half]]
    if t == 0:
        t = 1
    A = verts[lv < t]
    B = verts[lv >= t]
    if len(A) == 0 or len(B) == 0:
        return None
    # separator: B-side vertices adjacent to A
    amask = np.zeros(len(inset), bool)
    amask[A] = True
    nbrs, cnt = _neighbors_of(indptr, indices, B)
    touches = np.zeros(len(B), bool)
    np.logical_or.at(touches, np.repeat(np.arange(len(B)), cnt), amask[nbrs])
    S = B[touches]
    B2 = B[~touches]
    return A, B2, S


def _components(indptr, indices, verts, inset):
    """Connected components of the induced subgraph (BFS sweeps)."""
    label = np.full(len(inset), -1, np.int64)
    comps = []
    for v in verts:
        if label[v] >= 0:
            continue
        frontier = np.array([v], np.int64)
        label[frontier] = len(comps)
        members = [frontier]
        while len(frontier):
            nbrs, _ = _neighbors_of(indptr, indices, frontier)
            nxt = np.unique(nbrs)
            nxt = nxt[inset[nxt] & (label[nxt] < 0)]
            label[nxt] = len(comps)
            members.append(nxt)
            frontier = nxt
        comps.append(np.sort(np.concatenate(members)))
    return comps


def _dissect(indptr, indices, verts, leaf_size, nodes, depth, scratch):
    """Recursive nested dissection; returns the node id.

    Disconnected subgraphs (separators fragment the graph constantly) get a
    balanced binary MERGE over their components — without this, peeling one
    component per split produces an O(#components)-deep chain and the wave
    schedule degenerates to singleton batches."""
    if len(verts) <= leaf_size:
        nodes.append(dict(cols=verts, children=(), depth=depth))
        return len(nodes) - 1
    scratch[:] = False
    scratch[verts] = True
    comps = _components(indptr, indices, verts, scratch)
    if len(comps) > 1:
        # greedy balanced 2-partition of components by vertex count
        sizes = np.array([len(c) for c in comps])
        order = np.argsort(-sizes, kind="stable")
        g1, g2, s1, s2 = [], [], 0, 0
        for ci in order:
            if s1 <= s2:
                g1.append(comps[ci]); s1 += sizes[ci]
            else:
                g2.append(comps[ci]); s2 += sizes[ci]
        l = _dissect(indptr, indices, np.concatenate(g1), leaf_size, nodes, depth + 1, scratch)
        r = _dissect(indptr, indices, np.concatenate(g2), leaf_size, nodes, depth + 1, scratch)
        nodes.append(dict(cols=np.zeros(0, np.int64), children=(l, r), depth=depth))
        return len(nodes) - 1
    scratch[:] = False
    scratch[verts] = True
    split = _bisect(indptr, indices, verts, scratch)
    if split is None or len(split[2]) >= max(1, len(verts) // 2):
        nodes.append(dict(cols=verts, children=(), depth=depth))
        return len(nodes) - 1
    A, B, S = split
    l = _dissect(indptr, indices, A, leaf_size, nodes, depth + 1, scratch)
    r = (
        _dissect(indptr, indices, B, leaf_size, nodes, depth + 1, scratch)
        if len(B)
        else None
    )
    nodes.append(dict(cols=S, children=tuple(c for c in (l, r) if c is not None), depth=depth))
    return len(nodes) - 1


def build_chol_plan(
    graph: FactorGraph, block_name: str | None = None, leaf_size: int = 32
) -> CholPlan:
    """Nested dissection + symbolic multifrontal factorization (host)."""
    ell = build_ell_direct(graph, block_name)
    nb, d, K = ell.nb, ell.d, ell.K
    indptr, indices = _csr_from_ell(ell)

    nodes: list = []
    scratch = np.zeros(nb, bool)
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        root = _dissect(
            indptr, indices, np.arange(nb, dtype=np.int64), leaf_size, nodes, 0, scratch
        )
    finally:
        sys.setrecursionlimit(old_limit)

    # children may include isolated single-child chains (empty B side):
    # the symbolic pass below handles any child count 0..2.

    n_nodes = len(nodes)
    # --- postorder elimination positions -------------------------------
    post = []
    stack = [(root, False)]
    while stack:
        nid, done = stack.pop()
        if done:
            post.append(nid)
            continue
        stack.append((nid, True))
        for c in nodes[nid]["children"]:
            stack.append((c, False))
    post_index = np.zeros(n_nodes, np.int64)
    for i, nid in enumerate(post):
        post_index[nid] = i

    elim_node = np.full(nb, -1, np.int64)
    elim_pos = np.full(nb, -1, np.int64)
    counter = 0
    for nid in post:
        c = nodes[nid]["cols"]
        elim_node[c] = nid
        elim_pos[c] = counter + np.arange(len(c))
        counter += len(c)
    assert counter == nb and (elim_node >= 0).all()

    # --- boundaries bottom-up (postorder) ------------------------------
    eliminated = np.zeros(nb, bool)
    bnds: dict[int, np.ndarray] = {}
    for nid in post:
        nd = nodes[nid]
        c = nd["cols"]
        eliminated[c] = True
        cand = [bnds[ch] for ch in nd["children"]]
        if len(c):
            cand.append(np.unique(_neighbors_of(indptr, indices, c)[0]))
        cand = np.unique(np.concatenate(cand)) if cand else np.zeros(0, np.int64)
        bnd = cand[~eliminated[cand]]
        # deterministic frontal order: ascending elimination position
        bnds[nid] = bnd[np.argsort(elim_pos[bnd], kind="stable")]
    assert len(bnds[root]) == 0, "root boundary must be empty"

    # --- group nodes into waves by HEIGHT ------------------------------
    # (longest path to a leaf, not depth: a node runs as soon as its
    # children are done, so an unbalanced tree still batches wide — the
    # wave count is the tree height, not the deepest leaf chain)
    height = np.zeros(n_nodes, np.int64)
    for nid in post:  # children precede parents in postorder
        ch = nodes[nid]["children"]
        if ch:
            height[nid] = 1 + max(height[c] for c in ch)
    n_waves = int(height.max()) + 1

    # Within-wave SIZE BUCKETS: a wave's nodes vary widely in (k, b), and
    # padding every node to the wave max inflates the frontal gathers.
    # Nodes are sub-grouped by geometrically-padded (k, b) classes; groups
    # stay in wave order, so every child group still precedes its parent's.
    def _pad_up(x):
        if x <= 1:
            return 1
        p = 1
        while p < x:
            p = max(p + 1, int(p * 1.5))
        return p

    waves_nodes = []
    for w in range(n_waves):
        wn = [nid for nid in range(n_nodes) if height[nid] == w]
        buckets: dict = {}
        for nid in wn:
            key = (_pad_up(len(nodes[nid]["cols"])), _pad_up(len(bnds[nid])))
            buckets.setdefault(key, []).append(nid)
        for key in sorted(buckets):
            waves_nodes.append(buckets[key])
    # slot of node within its group
    slot_of = np.zeros(n_nodes, np.int64)
    wave_idx = np.zeros(n_nodes, np.int64)
    for wi, wn in enumerate(waves_nodes):
        for s, nid in enumerate(wn):
            slot_of[nid] = s
            wave_idx[nid] = wi

    # --- assign original entries to frontals ---------------------------
    # unique undirected edges + diagonals; entry enters at the elim node of
    # its earlier-eliminated endpoint.
    valid = ell.valid[:, 1:] > 0
    eu = np.repeat(np.arange(nb, dtype=np.int64), valid.sum(axis=1))
    ev = ell.cols[:, 1:][valid].astype(np.int64)
    slot_flat = (np.tile(np.arange(1, K, dtype=np.int64), (nb, 1)))[valid]
    ellpos_uv = eu * K + slot_flat  # flat pos of block (u, v)
    und = eu < ev
    E_u, E_v = eu[und], ev[und]
    pos_uv = ellpos_uv[und]
    # find pos of (v, u): build lookup from (u, v) key -> ellpos
    keys_all = eu * nb + ev
    order_all = np.argsort(keys_all, kind="stable")
    keys_sorted = keys_all[order_all]
    pos_sorted = ellpos_uv[order_all]
    loc = np.searchsorted(keys_sorted, E_v * nb + E_u)
    pos_vu = pos_sorted[loc]

    first = np.where(elim_pos[E_u] <= elim_pos[E_v], E_u, E_v)
    entry_node = elim_node[first]

    # --- per-wave padded tables ----------------------------------------
    # group edges and children by owner node once
    edge_order = np.argsort(entry_node, kind="stable")
    e_starts = np.searchsorted(entry_node[edge_order], np.arange(n_nodes + 1))

    kpad_w, bpad_w = [], []
    for wn in waves_nodes:
        kpad_w.append(max(1, max(len(nodes[n]["cols"]) for n in wn)))
        bpad_w.append(max(1, max(len(bnds[n]) for n in wn)))
    # one GLOBAL update-matrix pool: wave w writes its batched U blocks at
    # pool_base[w]; child gather tables address the pool absolutely, so
    # children may sit ANY number of waves below their parent
    pool_base = np.zeros(len(waves_nodes) + 1, np.int64)
    for wi, wn in enumerate(waves_nodes):
        pool_base[wi + 1] = pool_base[wi] + len(wn) * bpad_w[wi] * bpad_w[wi]
    pool_total = int(pool_base[-1])

    pos_of = np.full(nb, -1, np.int64)  # scratch frontal-position map
    waves_out = []
    for wi, wn in enumerate(waves_nodes):
        N = len(wn)
        kpad, bpad = kpad_w[wi], bpad_w[wi]
        f = kpad + bpad
        cols_idx = np.full((N, kpad), nb, np.int32)
        bnd_idx = np.full((N, bpad), nb, np.int32)
        col_pad = np.ones((N, kpad))
        tbl_orig = np.zeros((N, f, f), np.int32)
        tbl_l = np.zeros((N, f, f), np.int32)
        tbl_r = np.zeros((N, f, f), np.int32)
        for s, nid in enumerate(wn):
            c = nodes[nid]["cols"]
            b = bnds[nid]
            k_n, b_n = len(c), len(b)
            cols_idx[s, :k_n] = c
            bnd_idx[s, :b_n] = b
            col_pad[s, :k_n] = 0.0
            front = np.concatenate([c, b])
            pos_of[c] = np.arange(k_n)  # cols part
            pos_of[b] = kpad + np.arange(b_n)  # bnd part (after the pad gap)
            # original entries owned by this node
            ee = edge_order[e_starts[nid] : e_starts[nid + 1]]
            pu, pv = pos_of[E_u[ee]], pos_of[E_v[ee]]
            tbl_orig[s, pu, pv] = 1 + pos_uv[ee]
            tbl_orig[s, pv, pu] = 1 + pos_vu[ee]
            # diagonals of eliminated cols: ELL slot 0
            pc = pos_of[c]
            tbl_orig[s, pc, pc] = 1 + c * K
            # child updates
            for side, ch in enumerate(nodes[nid]["children"]):
                cb = bnds[ch]
                if len(cb) == 0:
                    continue
                cw = wave_idx[ch]
                cbpad = bpad_w[cw]
                base = pool_base[cw] + slot_of[ch] * cbpad * cbpad
                pp = pos_of[cb]
                grid = base + np.arange(len(cb))[:, None] * cbpad + np.arange(len(cb))[None, :]
                tbl = tbl_l if side == 0 else tbl_r
                tbl[s, pp[:, None], pp[None, :]] = 1 + grid
            pos_of[front] = -1
        waves_out.append(
            (kpad, bpad, N, cols_idx, bnd_idx, col_pad, tbl_orig, tbl_l, tbl_r)
        )

    return CholPlan(
        nb=nb, d=d, K=K, ell=ell, waves=tuple(waves_out), pool_total=pool_total
    )


# --------------------------------------------------------------------------
# Device-side: numeric factorization + solves
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceWave:
    """One wave of a ``CholPlan`` as tensors on one device (int64 indices,
    converted once per plan and device)."""

    kpad: int
    bpad: int
    N: int
    ci: torch.Tensor  # (N, kpad) eliminated variables, pad -> nb
    bi: torch.Tensor  # (N, bpad) boundary variables, pad -> nb
    col_pad: torch.Tensor  # (N, kpad * d) bool: the unit diagonal of pad columns
    tbl_orig: torch.Tensor  # (N, f, f)
    tbl_l: torch.Tensor | None  # (N, f, f); None where no node of the wave has a left child update
    tbl_r: torch.Tensor | None
    # the forward solve's update: the N * bpad boundary rows summed by
    # variable (``slot_reduce``; the pad row nb is the last slot), then
    # written to the n_real real variables ``fwd_dest``
    fwd_perm: torch.Tensor  # (N * bpad,) int32
    fwd_offsets: torch.Tensor  # (n_slots + 1,) int32
    fwd_dest: torch.Tensor  # (n_real,)
    # the backward solve's write: rows ``bwd_pos`` of the (N * kpad) solved
    # columns are the variables ``bwd_var``, each once
    bwd_pos: torch.Tensor
    bwd_var: torch.Tensor
    fwd_longest: int | None = None  # the forward plan's longest segment (``slot_reduce``'s ``longest``)

    @property
    def fwd_slots(self) -> int:
        return self.fwd_offsets.shape[0] - 1


def _sigma_scatter(tbl_l, tbl_r):
    """(src, pos) of a wave's hand-down in the selected-inverse sweep: the
    entries of the (N, f, f) tables ``tbl_l`` / ``tbl_r`` that name a pool
    position (not the zero block 0), flat front positions ``src`` and pool
    positions ``pos``.  Raises ValueError where a position is named twice:
    the copy ``pool[pos] = front[src]`` would then depend on the order of
    the writes."""
    srcs, poss = [], []
    for tbl in (tbl_l, tbl_r):
        flat = np.asarray(tbl).reshape(-1)
        src = np.flatnonzero(flat)
        srcs.append(src)
        poss.append(flat[src].astype(np.int64))
    src, pos = np.concatenate(srcs), np.concatenate(poss)
    if len(np.unique(pos)) != len(pos):
        raise ValueError("selected-inverse hand-down: a pool position is named twice by one wave's tables")
    return src, pos


def _device_wave(nb, d, wave, device):
    kpad, bpad, N, cols_idx, bnd_idx, col_pad, tbl_orig, tbl_l, tbl_r = wave

    def t(a, dtype=np.int64):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    dest = bnd_idx.reshape(-1).astype(np.int64)
    uniq, inv = np.unique(dest, return_inverse=True)
    sp = slot_plan(inv.reshape(-1), len(uniq))
    ci_flat = cols_idx.reshape(-1)
    pos = np.flatnonzero(ci_flat < nb)
    return DeviceWave(
        kpad, bpad, N, t(cols_idx), t(bnd_idx), t(np.repeat(col_pad > 0, d, axis=1), bool), t(tbl_orig),
        t(tbl_l) if tbl_l.any() else None, t(tbl_r) if tbl_r.any() else None,
        t(sp.perm, np.int32), t(sp.offsets, np.int32), t(uniq[uniq < nb]), t(pos), t(ci_flat[pos]), sp.longest,
    )


def _device_waves(plan: CholPlan, device) -> tuple:
    """The plan's waves as ``DeviceWave``s on ``device``, built once per plan
    and device and kept on the plan object."""
    device = torch.device(device)
    cache = plan.__dict__.setdefault("_dev_waves", {})
    if device not in cache:
        cache[device] = tuple(_device_wave(plan.nb, plan.d, w, device) for w in plan.waves)
    return cache[device]


def _sigma_scatters(plan: CholPlan, device) -> tuple:
    """Every wave's hand-down (``_sigma_scatter``) as (src, pos) int64
    tensors on ``device``: pool[pos] = the Sigma front's (N * f * f) blocks
    at src, every position once.  Built by the first selected-inverse sweep
    over the plan on that device and kept on the plan object; the
    factorization and the solves never need them."""
    device = torch.device(device)
    cache = plan.__dict__.setdefault("_sig_scatters", {})
    if device not in cache:
        cache[device] = tuple(tuple(torch.as_tensor(a, device=device) for a in _sigma_scatter(w[7], w[8]))
                              for w in plan.waves)
    return cache[device]


def _factorize(plan: CholPlan, He, lam=None):
    """Numeric multifrontal factorization of the ELL store He (nb, K, d, d).
    With ``lam``, Marquardt damping of the diagonal blocks (slot 0) first,
    on the factorization's own copy.  Returns per-wave (L11, L21) factors
    (leaf wave first)."""
    nb, d, K = plan.nb, plan.d, plan.K
    src = torch.cat([He.new_zeros((1, d, d)), He.reshape(nb * K, d, d)])
    if lam is not None:
        D = src[1 : 1 + nb * K : K]  # the slot-0 blocks, a view
        diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=1e-12)
        D += lam * torch.diag_embed(diag)
    # global update pool: row 0 is the zero block; wave w writes its update
    # blocks as one contiguous slice
    pool = He.new_zeros((1 + plan.pool_total, d, d))
    base = 1
    factors = []
    for w in _device_waves(plan, He.device):
        f, k = w.kpad + w.bpad, w.kpad * d
        F = src[w.tbl_orig]  # (N, f, f, d, d)
        if w.tbl_l is not None:
            F = F + pool[w.tbl_l]
        if w.tbl_r is not None:
            F = F + pool[w.tbl_r]
        F = F.permute(0, 1, 3, 2, 4).reshape(w.N, f * d, f * d)
        F11 = F[:, :k, :k]
        F11.diagonal(dim1=-2, dim2=-1).add_(w.col_pad)  # pad columns: unit diagonal
        L11 = _cholesky(F11)
        # L21 = F21 L11^-T
        L21 = torch.linalg.solve_triangular(L11.transpose(-1, -2), F[:, k:, :k], upper=True, left=False)
        U = F[:, k:, k:] - L21 @ L21.transpose(-1, -2)
        n = w.N * w.bpad * w.bpad
        pool[base : base + n] = U.reshape(w.N, w.bpad, d, w.bpad, d).permute(0, 1, 3, 2, 4).reshape(n, d, d)
        base += n
        factors.append((L11, L21))
    return factors


def _solve_factored(plan: CholPlan, factors, g):
    """Level-scheduled forward/backward substitution; g is (nb*d,) or a
    block of m right-hand sides (nb*d, m), and so is the result."""
    nb, d = plan.nb, plan.d
    m = g.shape[1] if g.dim() == 2 else 1
    bvec = torch.cat([g.reshape(nb, d, m), g.new_zeros((1, d, m))])
    ys = []
    waves = _device_waves(plan, g.device)
    for w, (L11, L21) in zip(waves, factors):
        bc = bvec[w.ci].reshape(w.N, w.kpad * d, m)
        y = torch.linalg.solve_triangular(L11, bc, upper=False)
        ys.append(y)
        n_real = w.fwd_dest.shape[0]
        if n_real:
            upd = (L21 @ y).reshape(w.N * w.bpad, d * m)
            bvec[w.fwd_dest] -= slot_reduce(upd, w.fwd_perm, w.fwd_offsets, w.fwd_slots, w.fwd_longest)[:n_real].reshape(-1, d, m)
    xvec = g.new_zeros((nb + 1, d, m))
    for w, (L11, L21), y in zip(reversed(waves), reversed(factors), reversed(ys)):
        xb = xvec[w.bi].reshape(w.N, w.bpad * d, m)
        rhs = y - L21.transpose(-1, -2) @ xb
        xc = torch.linalg.solve_triangular(L11.transpose(-1, -2), rhs, upper=True)
        xvec[w.bwd_var] = xc.reshape(w.N * w.kpad, d, m)[w.bwd_pos]
    return xvec[:nb].reshape(g.shape)


def locate_fill_pairs(plan: CholPlan, pairs):
    """Host: map (u, v) variable pairs to (wave, slot, p, q, swapped)
    positions in the Sigma-fronts of the selected-inverse sweep.  A pair is
    coverable iff it lies in the FILL pattern: u and v share a front at the
    node where the earlier-eliminated one is a column (original edges, e.g.
    odometry pairs, always qualify).  Raises ValueError on out-of-fill or
    out-of-range pairs.

    Cost is proportional to the query, not the fill: an O(nb) owner map
    from the cols tables, then front dicts only for the (at most two)
    candidate owner nodes of a pair."""
    nb = plan.nb
    owner = np.full(nb, -1, np.int64)  # var -> flat node id (wave-major)
    node_of = []  # flat node id -> (wave, slot)
    for wi, (kpad, bpad, N, cols_idx, bnd_idx, *_rest) in enumerate(plan.waves):
        for s in range(N):
            c = cols_idx[s]
            owner[c[c < nb]] = len(node_of)
            node_of.append((wi, s))

    fronts: dict[int, dict] = {}  # flat node id -> {var: front position}

    def front_of(nid):
        f = fronts.get(nid)
        if f is None:
            wi, s = node_of[nid]
            kpad, bpad, N, cols_idx, bnd_idx, *_rest = plan.waves[wi]
            f = {int(v): p for p, v in enumerate(cols_idx[s]) if v < nb}
            f.update({int(v): kpad + p for p, v in enumerate(bnd_idx[s]) if v < nb})
            fronts[nid] = f
        return f

    out = []
    for u, v in pairs:
        u, v = int(u), int(v)
        if not (0 <= u < nb and 0 <= v < nb):
            raise ValueError(f"pair ({u}, {v}) out of range for {nb} variables")
        hit = None
        for first, second, swapped in ((u, v, False), (v, u, True)):
            front = front_of(int(owner[first]))
            if second in front:
                # a swapped extraction reads Sigma_vu = Sigma_uv^T; the sweep
                # transposes it back before returning
                wi, s = node_of[int(owner[first])]
                hit = (wi, s, front[first], front[second], swapped)
                break
        if hit is None:
            raise ValueError(
                f"pair ({u}, {v}) is outside the factorization fill; use a column solve (covariance_block) for "
                "arbitrary pairs"
            )
        out.append(hit)
    return out


def selected_inverse_marginals(plan: CholPlan, factors, pairs=None):
    """Every (d, d) diagonal block of H^-1 in one sweep over the
    multifrontal factors in reverse wave order (the Takahashi / selected
    inversion recursion): (nb, d, d).  With ``pairs``, (u, v) variable pairs
    within the factorization fill (``locate_fill_pairs``), also their (d, d)
    cross blocks Sigma_uv, read out of the same sweep: returns (diag,
    blocks).

    Per node, with U = F11^-1 F12 = L11^-T L21^T:

        Sigma_CB = -U Sigma_BB
        Sigma_CC = F11^-1 + U Sigma_BB U^T

    where the factorization gathered each node's child updates into its
    front through ``tbl_l`` / ``tbl_r``, the sweep hands the parent's
    Sigma-front entries back through the same positions
    (``_sigma_scatters``), and each node reads its Sigma_BB from its
    own contiguous pool slice.  Padding stays inert: padded eliminated
    columns carry a unit diagonal, padded boundary rows of L21 are zero, and
    unwritten pool entries are zero; root nodes have an empty boundary.
    The triangular solves and products are batched over the nodes of a
    wave."""
    nb, d = plan.nb, plan.d
    L0 = factors[0][0]
    dtype, device = L0.dtype, L0.device
    waves = _device_waves(plan, device)
    scatters = _sigma_scatters(plan, device)
    pair_req = None
    if pairs is not None:
        located = locate_fill_pairs(plan, pairs)
        pair_req = {}  # wave -> [(slot, p, q, out id)]
        swapped = np.zeros(len(located), bool)
        for out_id, (wi, s, p, q, sw) in enumerate(located):
            pair_req.setdefault(wi, []).append((s, p, q, out_id))
            swapped[out_id] = sw
        pair_out = torch.zeros((len(located), d, d), dtype=dtype, device=device)
    # the pool layout of the factorization: wave w's updates from bases[w]
    bases = [1]
    for w in waves:
        bases.append(bases[-1] + w.N * w.bpad * w.bpad)
    pool = torch.zeros((1 + plan.pool_total, d, d), dtype=dtype, device=device)
    out = torch.zeros((nb, d, d), dtype=dtype, device=device)
    for wi in reversed(range(len(waves))):
        w = waves[wi]
        L11, L21 = factors[wi]
        f, k, b = w.kpad + w.bpad, w.kpad * d, w.bpad * d
        n = w.N * w.bpad * w.bpad
        # this node's Sigma_BB, handed down by its parent (zero at roots)
        Sbb = pool[bases[wi]:bases[wi] + n].reshape(w.N, w.bpad, w.bpad, d, d).permute(0, 1, 3, 2, 4)
        Sbb = Sbb.reshape(w.N, b, b)
        # U = L11^-T L21^T (k, b);  F11^-1 = L11^-T L11^-1
        U = torch.linalg.solve_triangular(L11.transpose(-1, -2), L21.transpose(-1, -2), upper=True)
        eye = torch.eye(k, dtype=dtype, device=device).expand(w.N, k, k)
        Linv = torch.linalg.solve_triangular(L11, eye, upper=False)
        F11inv = Linv.transpose(-1, -2) @ Linv
        USbb = U @ Sbb
        Scc = F11inv + USbb @ U.transpose(-1, -2)
        Scb = -USbb
        Sf = torch.cat([torch.cat([Scc, Scb], 2), torch.cat([Scb.transpose(-1, -2), Sbb], 2)], 1)
        Sf = Sf.reshape(w.N, f, d, f, d).permute(0, 1, 3, 2, 4)  # (N, f, f, d, d)
        # the eliminated variables' marginals, each written once
        diag = Sf[:, torch.arange(w.kpad), torch.arange(w.kpad)]  # (N, kpad, d, d)
        out[w.bwd_var] = diag.reshape(w.N * w.kpad, d, d)[w.bwd_pos]
        if pair_req is not None and wi in pair_req:
            ss, ps, qs, oi = (torch.as_tensor(c, device=device) for c in zip(*pair_req[wi]))
            pair_out[oi] = Sf[ss, ps, qs]
        # hand the children their Sigma_BB through the positions their
        # updates were gathered from
        sig_src, sig_pos = scatters[wi]
        if sig_pos.numel():
            pool[sig_pos] = Sf.reshape(-1, d, d)[sig_src]
    if pairs is not None:
        sw = torch.as_tensor(swapped, device=device)[:, None, None]
        return out, torch.where(sw, pair_out.transpose(-1, -2), pair_out)
    return out


def factor_logdet(plan: CholPlan, factors):
    """log det(H) from the multifrontal Cholesky factors: twice the sum of
    the log-diagonals of every wave's L11 (padding columns carry a unit
    diagonal, log 1 = 0)."""
    total = torch.zeros((), dtype=factors[0][0].dtype, device=factors[0][0].device)
    for L11, _ in factors:
        total = total + 2.0 * torch.sum(torch.log(torch.diagonal(L11, dim1=-2, dim2=-1)))
    return total


def sparse_chol_solve(plan: CholPlan, He, g, lam, opt: _lm.Options):
    """One exact linear solve of (He + damping) dx = g; He is not changed."""
    factors = _factorize(plan, He, lam if opt.method == "lm" else None)
    return _solve_factored(plan, factors, g)


# content of the ELL plan and device -> its EllDevicePlan (the assembly's
# tables on the device)
_DEVICE_PLANS = ClosureCache()


def solve_sparse_chol(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    plan: CholPlan | None = None,
    leaf_size: int = 32,
):
    """GN/LM with EXACT sparse direct linear solves (multifrontal block
    Cholesky): the dx of the dense path at O(fill) memory.  Shares the LM
    loop of ``lm.solve`` (one host read an iteration); the assembly is
    ``bcsr.assemble_ell``.  Returns (solved_graph, SolveInfo)."""
    if plan is None:
        plan = build_chol_plan(graph, leaf_size=leaf_size)
    device = next(iter(graph.blocks.values())).values.device
    key = ("sparse_chol", content_key(plan.ell), str(device))
    if key not in _DEVICE_PLANS:
        _DEVICE_PLANS[key] = ell_device_plan(plan.ell, device)
    dplan = _DEVICE_PLANS[key]
    _device_waves(plan, device)

    def assemble_fn(g):
        return assemble_ell(g, dplan)

    def solve_fn(He, g, lam, opt):
        return sparse_chol_solve(plan, He, g, lam, opt)

    return _lm.solve(graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn)


__all__ = [
    "CholPlan",
    "build_chol_plan",
    "factor_logdet",
    "locate_fill_pairs",
    "selected_inverse_marginals",
    "solve_sparse_chol",
    "sparse_chol_solve",
]
