"""Incremental smoothing with bucketed capacities.

Counterpart of ``pyslam_tpu/solver/incremental.py``: a growing graph
re-solved warm after each batch of new measurements.  Variables and
factors live in padded host arrays whose capacity grows geometrically
(x1.5 buckets); padding variables are frozen and padding factors carry
weight 0 with safe values, so they are inert.  The buckets decide which
graph is solved — its dense dimension and the route ``solve_auto`` takes —
and are kept as in the reference, so the port solves the reference's
graph.  ``compiles`` counts the changes of the structure key (capacities
and the carried priors' data shapes), as the reference counts its fresh
executables.

Each ``update()`` copies the live arrays to the device (``torch.tensor``,
never a view of a host array), solves there and reads the solved values
back into the host mirrors; the reference's copy-on-write of its mirrors
guards against its zero-copy transfer on the CPU, which the copy here
rules out.

Old state can be retired with ``marginalize_oldest`` (``graph.marginalize``
dense FEJ priors).  ``pose_marginals`` reads the live poses' covariances
(``solver/covariance.py``) by the reference's three branches.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..graph.core import MANIFOLDS, FactorBatch, FactorGraph, VariableBlock
from ..losses import L2Loss
from . import lm as _lm


def _bucket(n: int, cap: int, grow: float = 1.5) -> int:
    while cap < n:
        cap = int(np.ceil(cap * grow))
    return cap


class IncrementalSmoother:
    """Growing pose-graph smoother with geometric capacity buckets.

    kind: 'se3' | 'se2' | 'sim3'.  Factors are between-factors of that
    kind; the first pose is the gauge anchor.  ``update()`` solves the
    current graph warm-started from the previous estimate and returns
    (values, SolveInfo).

    Landmark SLAM: construct with ``obs_kind`` ('bearing_range_se2' |
    'landmark_xy_se2' | 'reprojection' | 'reprojection_bal' | any
    registered (pose, landmark) kernel with {obs, sqrt_info} data) and
    stream ``add_landmark`` / ``add_observation`` alongside poses.  Such
    graphs solve through ``solve_auto`` (the Schur routes).
    ``obs_dim`` / ``lm_dim`` default from the kind; ``obs_extras`` carries
    static per-batch data (the camera of 'reprojection').  ``device``:
    where the solves run (None: the CUDA card).
    """

    _OBS_DEFAULTS = {
        "bearing_range_se2": (2, 2),  # (obs_dim, lm_dim)
        "landmark_xy_se2": (2, 2),
        "reprojection": (3, 3),
        "reprojection_bal": (2, 3),
    }

    def __init__(self, kind: str = "se3", options: _lm.Options | None = None, init_capacity: int = 16,
                 dtype=torch.float64, obs_kind: str | None = None, obs_dim: int | None = None,
                 lm_dim: int | None = None, obs_extras: dict | None = None, device=None):
        if kind not in ("se3", "se2", "sim3"):
            raise ValueError(f"unsupported kind {kind!r}")
        self.device = resolve_device(device)
        self.kind = kind
        self.dtype = dtype
        self.opts = options or _lm.Options(method="lm", max_iters=15)
        m = MANIFOLDS[kind]
        self._mat = m["shape"][0]
        self._dof = m["dof"]
        self.n = 0  # live poses
        self.cap = init_capacity
        eye = np.eye(self._mat)
        self._T = np.tile(eye, (self.cap, 1, 1))
        self._const = np.ones(self.cap, bool)  # padding slots frozen
        # factor storage (between factors)
        self.m = 0
        self.fcap = init_capacity
        self._fi = np.zeros(self.fcap, np.int32)
        self._fj = np.zeros(self.fcap, np.int32)
        self._T_obs = np.tile(eye, (self.fcap, 1, 1))
        self._S = np.tile(np.eye(self._dof), (self.fcap, 1, 1))
        self._w = np.zeros(self.fcap)
        # landmark + observation storage (obs_kind graphs only)
        self.obs_kind = obs_kind
        self.obs_extras = dict(obs_extras or {})
        if obs_kind is not None:
            od, ld = self._OBS_DEFAULTS.get(obs_kind, (None, None))
            self.obs_dim = obs_dim if obs_dim is not None else od
            self.lm_dim = lm_dim if lm_dim is not None else ld
            if self.obs_dim is None or self.lm_dim is None:
                raise ValueError(f"obs_kind {obs_kind!r} needs explicit obs_dim/lm_dim")
            self.nl = 0  # live landmarks
            self.lcap = init_capacity
            # safe padding value: keeps every registered kernel finite on
            # padded slots (0 * inf = NaN would poison chi2); unit-z for
            # projective kernels
            self._lm_safe = np.zeros(self.lm_dim)
            self._lm_safe[-1] = 1.0
            self._L = np.tile(self._lm_safe, (self.lcap, 1))
            self._lconst = np.ones(self.lcap, bool)
            self.mo = 0  # live observations
            self.ocap = init_capacity
            self._oi = np.zeros(self.ocap, np.int32)  # pose index
            self._oj = np.zeros(self.ocap, np.int32)  # landmark index
            self._obs = np.zeros((self.ocap, self.obs_dim))
            self._obs[:, -1] = 1.0  # nonzero range/depth keeps kernels finite
            self._oS = np.tile(np.eye(self.obs_dim), (self.ocap, 1, 1))
            self._ow = np.zeros(self.ocap)
        self.compiles = 0  # structure-key changes
        self._prior_batches: list = []  # carried marginalization priors (on the device)

    # ------------------------------------------------------------ building
    def add_pose(self, T_init) -> int:
        if self.n == self.cap:
            new = _bucket(self.n + 1, self.cap)
            padT = np.tile(np.eye(self._mat), (new - self.cap, 1, 1))
            self._T = np.concatenate([self._T, padT])
            self._const = np.concatenate([self._const, np.ones(new - self.cap, bool)])
            self.cap = new
        i = self.n
        self._T[i] = np.asarray(T_init)
        self._const[i] = i == 0  # anchor stays const
        self.n += 1
        return i

    def add_between(self, i: int, j: int, T_obs, sqrt_info):
        if self.m == self.fcap:
            new = _bucket(self.m + 1, self.fcap)
            g = new - self.fcap
            self._fi = np.concatenate([self._fi, np.zeros(g, np.int32)])
            self._fj = np.concatenate([self._fj, np.zeros(g, np.int32)])
            self._T_obs = np.concatenate([self._T_obs, np.tile(np.eye(self._mat), (g, 1, 1))])
            self._S = np.concatenate([self._S, np.tile(np.eye(self._dof), (g, 1, 1))])
            self._w = np.concatenate([self._w, np.zeros(g)])
            self.fcap = new
        k = self.m
        self._fi[k], self._fj[k] = i, j
        self._T_obs[k] = np.asarray(T_obs)
        self._S[k] = np.asarray(sqrt_info)
        self._w[k] = 1.0
        self.m += 1

    def add_landmark(self, l_init) -> int:
        if self.obs_kind is None:
            raise ValueError("construct with obs_kind=... for landmark SLAM")
        if self.nl == self.lcap:
            new = _bucket(self.nl + 1, self.lcap)
            self._L = np.concatenate([self._L, np.tile(self._lm_safe, (new - self.lcap, 1))])
            self._lconst = np.concatenate([self._lconst, np.ones(new - self.lcap, bool)])
            self.lcap = new
        j = self.nl
        self._L[j] = np.asarray(l_init)
        self._lconst[j] = False
        self.nl += 1
        return j

    def add_observation(self, pose_i: int, lm_j: int, obs, sqrt_info):
        if self.obs_kind is None:
            raise ValueError("construct with obs_kind=... for landmark SLAM")
        if self.mo == self.ocap:
            new = _bucket(self.mo + 1, self.ocap)
            g = new - self.ocap
            # replicate row 0 into the padding (weight 0 masks it; a valid
            # row keeps any kernel finite — 0 * inf = NaN otherwise)
            self._oi = np.concatenate([self._oi, np.full(g, self._oi[0], np.int32)])
            self._oj = np.concatenate([self._oj, np.full(g, self._oj[0], np.int32)])
            self._obs = np.concatenate([self._obs, np.tile(self._obs[0], (g, 1))])
            self._oS = np.concatenate([self._oS, np.tile(self._oS[0], (g, 1, 1))])
            self._ow = np.concatenate([self._ow, np.zeros(g)])
            self.ocap = new
        k = self.mo
        self._oi[k], self._oj[k] = pose_i, lm_j
        self._obs[k] = np.asarray(obs)
        self._oS[k] = np.asarray(sqrt_info)
        self._ow[k] = 1.0
        if k == 0:
            # retro-fill the initial padding with the first valid row
            self._oi[1:] = pose_i
            self._oj[1:] = lm_j
            self._obs[1:] = self._obs[0]
            self._oS[1:] = self._oS[0]
        self.mo += 1

    def _t(self, a, dtype=None):
        """A copy of a host array on the device."""
        return torch.tensor(np.asarray(a), dtype=self.dtype if dtype is None else dtype, device=self.device)

    def _graph(self, n=None, m=None, nl=None, mo=None) -> FactorGraph:
        """Padded graph at full capacities (default) or compacted to exact
        live sizes (explicit n/m/nl/mo — the marginalization path)."""
        sl, fsl = slice(None, n), slice(None, m)
        blocks = {"poses": VariableBlock(self.kind, self._t(self._T[sl]), self._t(self._const[sl], torch.bool))}
        batches = [
            FactorBatch(
                f"between_{self.kind}",
                ("poses", "poses"),
                (self._t(self._fi[fsl], torch.int64), self._t(self._fj[fsl], torch.int64)),
                {"T_obs": self._t(self._T_obs[fsl]), "sqrt_info": self._t(self._S[fsl])},
                L2Loss(),
                self._t(self._w[fsl]),
            )
        ]
        if self.obs_kind is not None:
            lsl, osl = slice(None, nl), slice(None, mo)
            blocks["landmarks"] = VariableBlock("euclidean", self._t(self._L[lsl]),
                                                self._t(self._lconst[lsl], torch.bool))
            data = {"obs": self._t(self._obs[osl]), "sqrt_info": self._t(self._oS[osl])}
            data.update(self.obs_extras)
            batches.append(
                FactorBatch(
                    self.obs_kind,
                    ("poses", "landmarks"),
                    (self._t(self._oi[osl], torch.int64), self._t(self._oj[osl], torch.int64)),
                    data,
                    L2Loss(),
                    self._t(self._ow[osl]),
                )
            )
        return FactorGraph(blocks, batches + self._prior_batches)

    # ------------------------------------------------------------- solving
    def update(self):
        """Solve the current graph warm-started from the last estimate.
        A change of capacity or of the carried priors' shapes is counted in
        ``compiles``.  Landmark graphs dispatch through ``solve_auto``
        (Schur routing)."""
        g = self._graph()
        key = (
            self.cap,
            self.fcap,
            (self.lcap, self.ocap) if self.obs_kind is not None else None,
            tuple(
                (fb.kind, tuple(sorted((k, tuple(getattr(v, "shape", ()))) for k, v in fb.data.items())))
                for fb in self._prior_batches
            ),
        )
        if key != getattr(self, "_last_key", None):
            self.compiles += 1
            self._last_key = key
        if self.obs_kind is not None:
            # Schur routing needs every batch in the (p,), (l,), (p,p),
            # (p,l) patterns; marginalization priors over a mixed
            # pose+landmark blanket are multi-slot — those graphs take the
            # generic dense assembly (window-scale after marginalization)
            schur_ok = all(
                set(fb.slots) <= {"poses", "landmarks"} and len(fb.slots) <= 2
                and fb.slots != ("landmarks", "poses")
                for fb in self._prior_batches
            )
            if schur_ok:
                from . import solve_auto

                # schur_sparse_pair_budget=0, as the reference: the sparse
                # Schur plan is keyed on the observation indices, which
                # change every update
                solved, info = solve_auto(g, self.opts, schur_sparse_pair_budget=0)
            else:
                solved, info = _lm.solve(g, self.opts)
            self._L = solved.blocks["landmarks"].values.detach().to("cpu", torch.float64).numpy()
        else:
            solved, info = _lm.solve(g, self.opts)
        self._T = solved.blocks["poses"].values.detach().to("cpu", torch.float64).numpy()
        return self._T[: self.n], info

    def poses(self):
        return self._T[: self.n].copy()

    def landmarks(self):
        if self.obs_kind is None:
            raise ValueError("no landmark block (construct with obs_kind=...)")
        return self._L[: self.nl].copy()

    def pose_marginals(self):
        """(n, dof, dof) marginal covariances of the live poses at the
        current estimate, as a host array.  Pose-only graphs whose priors
        are single-slot: the exact multifrontal selected inverse
        (``marginal_covariances_direct``); landmark graphs: S-solves on the
        reduced camera system (``pose_marginal_covariances``); graphs that
        carry a multi-slot marginalization prior: the dense inverse
        (``full_covariance``, window-scale after marginalization)."""
        from .covariance import full_covariance, marginal_covariances_direct, pose_marginal_covariances

        g = self._graph(
            n=self.n, m=self.m,
            nl=self.nl if self.obs_kind is not None else None,
            mo=self.mo if self.obs_kind is not None else None,
        )
        dof = self._dof
        if self.obs_kind is None and all(len(set(fb.slots)) == 1 for fb in self._prior_batches):
            out = marginal_covariances_direct(g)
        elif self.obs_kind is not None and all(
            fb.slots in (("poses",), ("poses", "poses"), ("poses", "landmarks")) for fb in self._prior_batches
        ):
            out = pose_marginal_covariances(g)
        else:
            off = g.offsets()["poses"]
            Sig = full_covariance(g)[off:off + self.n * dof, off:off + self.n * dof]
            out = Sig.reshape(self.n, dof, self.n, dof).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
        return out.detach().to("cpu", torch.float64).numpy()

    # -------------------------------------------------------- marginalizing
    def marginalize_oldest(self, keep_last: int):
        """Retire old poses into a dense FEJ prior (``graph.marginalize``),
        keeping the gauge anchor (pose 0) plus the newest ``keep_last``
        poses.  This REINDEXES poses (1 becomes the oldest kept non-anchor
        pose) and changes the graph structure."""
        from ..graph.marginalize import marginalize

        if self.n <= keep_last:
            return
        # compact to live sizes first (marginalize works on exact arrays)
        live = self._graph(n=self.n, m=self.m, nl=self.nl if self.obs_kind else None,
                           mo=self.mo if self.obs_kind else None)
        # the anchor must survive (marginalize refuses const targets): retire
        # poses 1 .. n-keep_last-1, keeping 0 plus the newest keep_last
        g2 = marginalize(live, {"poses": list(range(1, self.n - keep_last))})

        def host(t):
            return t.detach().to("cpu").numpy()

        blk = g2.blocks["poses"]
        n_new = blk.n
        self.n = n_new
        self.cap = _bucket(n_new, 16)
        eye = np.eye(self._mat)
        self._T = np.tile(eye, (self.cap, 1, 1))
        self._T[:n_new] = host(blk.values)
        self._const = np.ones(self.cap, bool)
        self._const[:n_new] = host(blk.const_mask)
        # split surviving batches back into between/observation storage +
        # carried priors (observations of retired poses were consumed into
        # the dense prior; surviving ones keep their landmark)
        self._prior_batches = []
        bi, bj, bT, bS, bw = [], [], [], [], []
        oi, oj, oo, oS, ow = [], [], [], [], []
        for fb in g2.batches:
            if fb.kind == f"between_{self.kind}":
                bi.append(host(fb.indices[0]))
                bj.append(host(fb.indices[1]))
                bT.append(host(fb.data["T_obs"]))
                bS.append(host(fb.data["sqrt_info"]))
                bw.append(host(fb.weight))
            elif self.obs_kind is not None and fb.kind == self.obs_kind:
                oi.append(host(fb.indices[0]))
                oj.append(host(fb.indices[1]))
                oo.append(host(fb.data["obs"]))
                oS.append(host(fb.data["sqrt_info"]))
                ow.append(host(fb.weight))
            else:
                self._prior_batches.append(fb)
        self.m = sum(len(x) for x in bi)
        self.fcap = _bucket(max(self.m, 1), 16)
        self._fi = np.zeros(self.fcap, np.int32)
        self._fj = np.zeros(self.fcap, np.int32)
        self._T_obs = np.tile(eye, (self.fcap, 1, 1))
        self._S = np.tile(np.eye(self._dof), (self.fcap, 1, 1))
        self._w = np.zeros(self.fcap)
        if self.m:
            self._fi[: self.m] = np.concatenate(bi)
            self._fj[: self.m] = np.concatenate(bj)
            self._T_obs[: self.m] = np.concatenate(bT)
            self._S[: self.m] = np.concatenate(bS)
            self._w[: self.m] = np.concatenate(bw)
        if self.obs_kind is not None:
            lblk = g2.blocks["landmarks"]
            self.nl = lblk.n
            self.lcap = _bucket(max(self.nl, 1), 16)
            self._L = np.tile(self._lm_safe, (self.lcap, 1))
            self._L[: self.nl] = host(lblk.values)
            self._lconst = np.ones(self.lcap, bool)
            self._lconst[: self.nl] = host(lblk.const_mask)
            self.mo = sum(len(x) for x in oi)
            self.ocap = _bucket(max(self.mo, 1), 16)
            self._oi = np.zeros(self.ocap, np.int32)
            self._oj = np.zeros(self.ocap, np.int32)
            self._obs = np.zeros((self.ocap, self.obs_dim))
            self._obs[:, -1] = 1.0
            self._oS = np.tile(np.eye(self.obs_dim), (self.ocap, 1, 1))
            self._ow = np.zeros(self.ocap)
            if self.mo:
                self._oi[: self.mo] = np.concatenate(oi)
                self._oj[: self.mo] = np.concatenate(oj)
                self._obs[: self.mo] = np.concatenate(oo)
                self._oS[: self.mo] = np.concatenate(oS)
                self._ow[: self.mo] = np.concatenate(ow)
                # safe padding: replicate the first surviving row
                self._oi[self.mo:] = self._oi[0]
                self._oj[self.mo:] = self._oj[0]
                self._obs[self.mo:] = self._obs[0]
                self._oS[self.mo:] = self._oS[0]


__all__ = ["IncrementalSmoother"]
