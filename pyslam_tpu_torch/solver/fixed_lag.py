"""Fixed-lag smoothers: sliding-window GN with a dense marginalization prior.

Counterpart of ``pyslam_tpu/solver/fixed_lag.py``: ``FixedLagSmoother``
(a window of poses) and ``FixedLagLandmarkSmoother`` (a window of poses
plus a pool of landmark slots).  A bounded window is optimized every frame;
poses leaving the window and evicted landmarks are MARGINALIZED, not
dropped: their information is folded into a dense Gaussian prior on the
remaining window by a Schur complement, with first-estimate (frozen)
linearization points.

Prior convention: cost_p(x) = 1/2 eta^T Hp eta + bp^T eta with
eta_i = log(T_i * Tlin_i^-1), the LEFT tangent offset from the frozen
linearization point, as every kernel of ``graph/factor_defs.py`` perturbs.

On the device, as in the reference:

* Static shapes: the window is padded to ``window`` poses (and
  ``lm_slots`` landmarks) and ``capacity`` factors (weight 0 = hole);
  padding variables are frozen.
* An update is ``gn_iters`` steps of ``assemble_dense`` (its sums the
  ``slot_reduce`` kernel), the prior added on the device and a dense solve
  (``torch.linalg.solve_ex``): no host read inside the loop.  ``update()``
  then reads the window's poses once, as the reference's ``poses()`` does.
* The marginalizations invert the eliminated block with
  ``torch.linalg.inv_ex`` (no read) and write the reduced prior with plain
  writes at unique positions.

On the host: the factor bookkeeping (slot ids, the pose and landmark
indices, free lists) in numpy, and the dense-assembly plan
(``assemble.DensePlan``), which depends on the index mirrors alone.  It is
rebuilt, from the host mirrors and with no device read, when they change
(``add_factor`` / ``add_observation``, a marginalization, a retirement),
at the next update or marginalization, and never inside the GN loop.
Every host array goes to the device as a copy (``torch.tensor``): on the
CPU ``torch.from_numpy`` would share the array's memory, and a later host
edit would move the state (the reference copies its mirrors on write for
the same reason).  Arrays handed back (``poses()``, ``landmark()``) are
copies too.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..graph.core import FactorBatch, FactorGraph, VariableBlock
from ..lie import se2, se3, sim3
from ..losses import L2Loss
from .assemble import assemble_dense, dense_plan

_OPS = {"se3": se3, "se2": se2, "sim3": sim3}
_DOF = {"se3": 6, "se2": 3, "sim3": 7}
_MAT = {"se3": 4, "se2": 3, "sim3": 4}


def _host_copy(t):
    """A numpy array that owns its memory (never a view of the tensor)."""
    return t.detach().to("cpu", copy=True).numpy()


class FixedLagSmoother:
    """Sliding-window pose smoother with dense marginalization.

    window:    number of poses kept live.
    capacity:  max factors simultaneously in the window (default 6/pose).
    kind:      'se3' | 'se2' | 'sim3' (scale-drift-aware windows).
    gn_iters:  GN iterations per ``update`` call.
    anchor_sqrt_info: the world frame is fixed by a strong unary prior on
        the first pose folded into the marginalization prior (a constant
        first pose would leave the prior rank-deficient after it leaves
        the window).
    device:    where the state lives (None: the package's default, the
        CUDA card).
    """

    def __init__(
        self,
        window: int = 16,
        kind: str = "se3",
        capacity: int | None = None,
        gn_iters: int = 3,
        anchor_sqrt_info: float = 1e3,
        damping: float = 1e-9,
        dtype=torch.float32,
        device=None,
    ):
        if kind not in _OPS:
            raise ValueError(f"kind must be one of {sorted(_OPS)}")
        self.device = resolve_device(device)
        self.window = int(window)
        self.kind = kind
        self.capacity = int(capacity if capacity is not None else 6 * window)
        self.gn_iters = int(gn_iters)
        self.damping = float(damping)
        self.dtype = dtype
        W, d, m = self.window, _DOF[kind], _MAT[kind]
        self._d, self._m = d, m

        # device state
        self.T = self._eye(m, W)
        self.Tlin = self.T.clone()
        self.Hp = torch.zeros((W * d, W * d), dtype=dtype, device=self.device)
        self.bp = torch.zeros(W * d, dtype=dtype, device=self.device)
        C = self.capacity
        self.T_obs = self._eye(m, C)
        self.sqrt_info = self._eye(d, C)
        self.fw = torch.zeros(C, dtype=dtype, device=self.device)

        # host mirrors (shape the device call; never ride in it)
        self.fi = np.zeros(C, np.int32)
        self.fj = np.zeros(C, np.int32)
        self._slot_free = np.ones(C, bool)
        self.count = 0  # live poses
        self.first_id = 0  # absolute id of window slot 0
        self._anchor_si = float(anchor_sqrt_info)
        self._plan = None  # dense plan of the current index mirrors
        self.plans_built = 0

    def _eye(self, n, count):
        return torch.eye(n, dtype=self.dtype, device=self.device).repeat(count, 1, 1)

    def _t(self, a):
        """A value as a tensor of the state's dtype on its device, always a
        copy."""
        if torch.is_tensor(a):
            return a.to(dtype=self.dtype, device=self.device, copy=True)
        return torch.tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    # host-side bookkeeping
    # ------------------------------------------------------------------
    @property
    def next_id(self) -> int:
        """Absolute id the next added pose will get."""
        return self.first_id + self.count

    def window_ids(self):
        return range(self.first_id, self.first_id + self.count)

    def poses(self) -> np.ndarray:
        """(count, m, m) current window estimates, oldest first (a copy)."""
        return _host_copy(self.T[: self.count])

    def pose(self, abs_id: int) -> np.ndarray:
        s = abs_id - self.first_id
        if not 0 <= s < self.count:
            raise KeyError(f"pose {abs_id} not in window [{self.first_id}, {self.next_id})")
        return _host_copy(self.T[s])

    def _alloc_slot(self) -> int:
        free = np.flatnonzero(self._slot_free)
        if free.size == 0:
            raise RuntimeError(f"factor capacity {self.capacity} exhausted; raise `capacity`")
        return int(free[0])

    def _set_pose(self, slot: int, T_new):
        v = self._t(T_new)
        self.T[slot] = v
        self.Tlin[slot] = v

    # ------------------------------------------------------------------
    # graph construction API
    # ------------------------------------------------------------------
    def add_pose(self, T_init) -> int:
        """Append a pose at an explicit initial estimate; returns its
        absolute id.  Marginalizes the oldest pose first if the window is
        full.  The first pose is anchored (world frame) via the prior."""
        if self.count == self.window:
            self._marginalize_oldest()
        slot = self.count
        self._set_pose(slot, T_init)
        if self.first_id == 0 and slot == 0:
            d = self._d
            si = self._anchor_si
            self.Hp[:d, :d] = torch.eye(d, dtype=self.dtype, device=self.device) * (si * si)
        self.count += 1
        return self.next_id - 1

    def add_odometry(self, T_meas, sqrt_info) -> int:
        """Append a pose predicted by composing the measurement onto the
        newest pose (T_new = T_meas @ T_last) and connect them with a
        between factor.  Returns the new pose's absolute id."""
        if self.count == 0:
            raise RuntimeError("add the initial pose first (add_pose)")
        last = self.next_id - 1
        T_pred = self._t(T_meas) @ self.T[last - self.first_id]
        new = self.add_pose(T_pred)
        self.add_factor(last, new, T_meas, sqrt_info)
        return new

    def add_factor(self, i: int, j: int, T_meas, sqrt_info):
        """Between factor (absolute pose ids, both inside the window):
        measurement T_j_i with the standard kernel convention
        T_est = T_j @ T_i^-1."""
        si, sj = i - self.first_id, j - self.first_id
        if not (0 <= si < self.count and 0 <= sj < self.count):
            raise KeyError(f"factor ({i},{j}) outside window [{self.first_id}, {self.next_id})")
        k = self._alloc_slot()
        self._slot_free[k] = False
        self.fi[k], self.fj[k] = si, sj
        self._plan = None
        self.T_obs[k] = self._t(T_meas)
        self.sqrt_info[k] = self._t(sqrt_info)
        self.fw[k] = 1.0

    # ------------------------------------------------------------------
    # device math
    # ------------------------------------------------------------------
    def _graph(self, T, valid, fi, fj, fw):
        blocks = {"poses": VariableBlock(self.kind, T, ~valid)}  # invalid slots frozen
        batch = FactorBatch(
            kind=f"between_{self.kind}",
            slots=("poses", "poses"),
            indices=(fi, fj),
            data={"T_obs": self.T_obs, "sqrt_info": self.sqrt_info},
            loss=L2Loss(),
            weight=fw,
        )
        return FactorGraph(blocks, [batch])

    def _device_plan(self):
        """(plan, fi, fj on the device, valid): the dense plan is rebuilt
        from the host mirrors when they changed; the index tensors are
        copies of the mirrors."""
        if self._plan is None:
            # the plan reads indices on the host: a graph with CPU index
            # tensors over the device's blocks gives it with no device read
            host_idx = (torch.tensor(self.fi, dtype=torch.int64), torch.tensor(self.fj, dtype=torch.int64))
            self._plan = (
                dense_plan(self._graph(self.T, torch.ones(self.window, dtype=torch.bool, device=self.device),
                                       *host_idx, self.fw)),
                *(t.to(self.device) for t in host_idx),
            )
            self.plans_built += 1
        valid = torch.arange(self.window, device=self.device) < self.count
        return (*self._plan, valid)

    def _gn(self):
        self._gn_steps(*self._device_plan())

    def _gn_steps(self, plan, fi, fj, valid):
        """``gn_iters`` GN steps on the device: no host read, no transfer."""
        W, d = self.window, self._d
        ops = _OPS[self.kind]
        free = valid.repeat_interleave(d).to(self.dtype)
        prior_mask = free[:, None] * free[None, :]
        Hp_free = self.Hp * prior_mask
        damping = self.damping * torch.eye(W * d, dtype=self.dtype, device=self.device)
        Tlin_inv = ops.inv(self.Tlin)
        T = self.T
        for _ in range(self.gn_iters):
            H, grad, _ = assemble_dense(self._graph(T, valid, fi, fj, self.fw), plan)
            eta = ops.log(T @ Tlin_inv).reshape(-1)
            grad = grad - (self.Hp @ eta + self.bp) * free
            dx, _ = torch.linalg.solve_ex(H + Hp_free + damping, grad)
            T = ops.perturb(T, (dx * free).reshape(W, d))
        self.T = T

    def _marginalize_oldest(self):
        """Consume the prior and the factors touching slot 0, Schur-eliminate
        slot 0, shift the window down one."""
        plan, fi, fj, valid = self._device_plan()
        W, d = self.window, self._d
        ops = _OPS[self.kind]
        live = ~self._slot_free
        adj = live & ((self.fi == 0) | (self.fj == 0))
        adj_t = torch.tensor(adj, dtype=self.dtype, device=self.device)
        H_a, grad_a, _ = assemble_dense(self._graph(self.T, valid, fi, fj, self.fw * adj_t), plan)
        # assemble_dense puts a unit diagonal on frozen rows — remove it: the
        # prior must stay exactly the consumed information
        free = valid.repeat_interleave(d).to(self.dtype)
        H_a.diagonal().sub_(1.0 - free)
        eta = ops.log(self.T @ ops.inv(self.Tlin)).reshape(-1)
        grad = grad_a - (self.Hp @ eta + self.bp) * free
        H = H_a + self.Hp * free[:, None] * free[None, :]
        B = H[d:, :d]
        CmI, _ = torch.linalg.inv_ex(H[:d, :d])
        Hp_new = torch.zeros_like(self.Hp)
        bp_new = torch.zeros_like(self.bp)
        Hp_new[: (W - 1) * d, : (W - 1) * d] = H[d:, d:] - B @ CmI @ B.T
        bp_new[: (W - 1) * d] = -(grad[d:] - B @ (CmI @ grad[:d]))
        self.Hp, self.bp = Hp_new, bp_new
        self.T = torch.roll(self.T, -1, dims=0)
        # relinearize the prior at the (shifted) current estimates
        self.Tlin = self.T.clone()
        # drop consumed factors; shift the rest down one slot
        self.fw = self.fw * (1.0 - adj_t)
        self._slot_free |= adj
        keep = ~self._slot_free
        self.fi[keep] -= 1
        self.fj[keep] -= 1
        self._plan = None
        self.count -= 1
        self.first_id += 1

    # ------------------------------------------------------------------
    # the per-frame entry point
    # ------------------------------------------------------------------
    def update(self):
        """Run the window GN; returns (count, m, m) estimates, oldest
        first (the one host read of a frame)."""
        self._gn()
        return self.poses()


class FixedLagLandmarkSmoother:
    """Sliding-window smoother with landmark slots (VIO / online landmark
    SLAM): a bounded window of poses plus a bounded pool of landmark slots
    is optimized every frame; poses leaving the window and landmarks
    evicted under slot pressure are MARGINALIZED into one dense Gaussian
    prior over the whole window state (first-estimate linearization of the
    consumed factors).

    The window state is one dense tangent vector in the FactorGraph's
    sorted block order — landmarks (L*ld dims) first, poses (W*d) after —
    so the prior (Hp, bp), the GN update and both marginalizations work on
    one layout for the whole sequence.  Retiring the landmark of a slot
    rotates that slot's dims to the front by a host-built permutation.

    obs_kind: any registered (pose, landmark) kernel with {obs, sqrt_info}
    data — 'landmark_xy_se2', 'bearing_range_se2', 'landmark_xyz_se3',
    'reprojection' (pass the camera via ``obs_extras``).
    device: where the state lives (None: the CUDA card).
    """

    _OBS_DEFAULTS = {
        "bearing_range_se2": (2, 2),  # (obs_dim, lm_dim)
        "landmark_xy_se2": (2, 2),
        "landmark_xyz_se3": (3, 3),
        "reprojection": (3, 3),
    }

    def __init__(
        self,
        window: int = 10,
        lm_slots: int = 64,
        obs_kind: str = "landmark_xyz_se3",
        kind: str = "se3",
        capacity: int | None = None,
        obs_capacity: int | None = None,
        gn_iters: int = 3,
        anchor_sqrt_info: float = 1e3,
        damping: float = 1e-9,
        dtype=torch.float32,
        obs_dim: int | None = None,
        lm_dim: int | None = None,
        obs_extras: dict | None = None,
        device=None,
    ):
        if kind not in _OPS:
            raise ValueError(f"kind must be one of {sorted(_OPS)}")
        od, ld = self._OBS_DEFAULTS.get(obs_kind, (None, None))
        self.obs_dim = obs_dim if obs_dim is not None else od
        self.lm_dim = lm_dim if lm_dim is not None else ld
        if self.obs_dim is None or self.lm_dim is None:
            raise ValueError(f"obs_kind {obs_kind!r} needs explicit obs_dim/lm_dim")
        self.device = resolve_device(device)
        self.window = int(window)
        self.lm_slots = int(lm_slots)
        self.kind = kind
        self.obs_kind = obs_kind
        self.obs_extras = dict(obs_extras or {})
        self.capacity = int(capacity if capacity is not None else 4 * window)
        self.obs_capacity = int(obs_capacity if obs_capacity is not None else window * lm_slots)
        self.gn_iters = int(gn_iters)
        self.damping = float(damping)
        self.dtype = dtype
        W, d, m = self.window, _DOF[kind], _MAT[kind]
        L, ld = self.lm_slots, self.lm_dim
        self._d, self._m = d, m
        # dense tangent layout = FactorGraph sorted block order:
        # 'landmarks' < 'poses'  ->  [L*ld landmark dims | W*d pose dims]
        self._off_p = L * ld
        self._D = L * ld + W * d

        # device state
        self.T = self._eye(m, W)
        self.Tlin = self.T.clone()
        # safe padding landmark: a unit last component keeps projective and
        # bearing-range kernels finite on weight-0 rows (0 * inf = NaN would
        # poison the sums)
        safe = np.zeros(ld)
        safe[-1] = 1.0
        self._lm_safe = safe
        self.Lm = self._t(np.tile(safe, (L, 1)))
        self.Lmlin = self.Lm.clone()
        self.Hp = torch.zeros((self._D, self._D), dtype=dtype, device=self.device)
        self.bp = torch.zeros(self._D, dtype=dtype, device=self.device)
        C, Co = self.capacity, self.obs_capacity
        self.T_obs = self._eye(m, C)
        self.b_sqrt = self._eye(d, C)
        self.bw = torch.zeros(C, dtype=dtype, device=self.device)
        self.obs = self._t(np.tile(np.eye(1, self.obs_dim, self.obs_dim - 1)[0], (Co, 1)))
        self.o_sqrt = self._eye(self.obs_dim, Co)
        self.ow = torch.zeros(Co, dtype=dtype, device=self.device)

        # host mirrors (shape the device call; never ride in it)
        self.bi = np.zeros(C, np.int32)
        self.bj = np.zeros(C, np.int32)
        self._bfree = np.ones(C, bool)
        self.oi = np.zeros(Co, np.int32)  # observing pose slot
        self.oj = np.zeros(Co, np.int32)  # observed landmark slot
        self._ofree = np.ones(Co, bool)
        self._lm_free = np.ones(L, bool)
        self._lm_id2slot: dict[int, int] = {}
        self._lm_slot2id = np.full(L, -1, np.int64)
        self._next_lm_id = 0
        self.count = 0
        self.first_id = 0
        self._anchor_si = float(anchor_sqrt_info)
        self._plan = None
        self._lvalid = None  # the landmark slots in use, on the device
        self.plans_built = 0

    _eye = FixedLagSmoother._eye
    _t = FixedLagSmoother._t

    # ------------------------------------------------------------------
    # host-side bookkeeping
    # ------------------------------------------------------------------
    @property
    def next_id(self) -> int:
        return self.first_id + self.count

    def window_ids(self):
        return range(self.first_id, self.first_id + self.count)

    def landmark_ids(self):
        return sorted(self._lm_id2slot)

    def poses(self) -> np.ndarray:
        return _host_copy(self.T[: self.count])

    def pose(self, abs_id: int) -> np.ndarray:
        s = abs_id - self.first_id
        if not 0 <= s < self.count:
            raise KeyError(f"pose {abs_id} not in window [{self.first_id}, {self.next_id})")
        return _host_copy(self.T[s])

    def landmark(self, lm_id: int) -> np.ndarray:
        if lm_id not in self._lm_id2slot:
            raise KeyError(f"landmark {lm_id} not live (retired or never added)")
        return _host_copy(self.Lm[self._lm_id2slot[lm_id]])

    def landmarks(self) -> dict:
        Lm = _host_copy(self.Lm)
        return {i: Lm[s].copy() for i, s in self._lm_id2slot.items()}

    def _alloc(self, free: np.ndarray, what: str) -> int:
        idx = np.flatnonzero(free)
        if idx.size == 0:
            raise RuntimeError(f"{what} capacity exhausted; raise the limit")
        return int(idx[0])

    # ------------------------------------------------------------------
    # graph construction API
    # ------------------------------------------------------------------
    def add_pose(self, T_init) -> int:
        if self.count == self.window:
            self._marginalize_oldest()
        slot = self.count
        v = self._t(T_init)
        self.T[slot] = v
        self.Tlin[slot] = v
        if self.first_id == 0 and slot == 0:
            d, o = self._d, self._off_p
            self.Hp[o : o + d, o : o + d] = torch.eye(d, dtype=self.dtype, device=self.device) * self._anchor_si**2
        self.count += 1
        return self.next_id - 1

    def add_odometry(self, T_meas, sqrt_info) -> int:
        if self.count == 0:
            raise RuntimeError("add the initial pose first (add_pose)")
        last = self.next_id - 1
        T_pred = self._t(T_meas) @ self.T[last - self.first_id]
        new = self.add_pose(T_pred)
        self.add_factor(last, new, T_meas, sqrt_info)
        return new

    def add_factor(self, i: int, j: int, T_meas, sqrt_info):
        """Between factor on absolute pose ids (T_obs = T_j @ T_i^-1)."""
        si, sj = i - self.first_id, j - self.first_id
        if not (0 <= si < self.count and 0 <= sj < self.count):
            raise KeyError(f"factor ({i},{j}) outside window [{self.first_id}, {self.next_id})")
        k = self._alloc(self._bfree, "between-factor")
        self._bfree[k] = False
        self.bi[k], self.bj[k] = si, sj
        self._plan = None
        self.T_obs[k] = self._t(T_meas)
        self.b_sqrt[k] = self._t(sqrt_info)
        self.bw[k] = 1.0

    def add_landmark(self, l_init) -> int:
        """Add a landmark; returns its id.  Under slot pressure the oldest
        live landmark with no remaining observations is evicted
        (marginalized) to make room."""
        if not self._lm_free.any():
            self._evict_unobserved()
        slot = self._alloc(self._lm_free, "landmark-slot")
        self._lm_free[slot] = False
        self._lvalid = None
        lm_id = self._next_lm_id
        self._next_lm_id += 1
        self._lm_id2slot[lm_id] = slot
        self._lm_slot2id[slot] = lm_id
        v = self._t(l_init)
        self.Lm[slot] = v
        self.Lmlin[slot] = v
        return lm_id

    def add_observation(self, pose_id: int, lm_id: int, obs, sqrt_info):
        sp = pose_id - self.first_id
        if not 0 <= sp < self.count:
            raise KeyError(f"pose {pose_id} not in window [{self.first_id}, {self.next_id})")
        if lm_id not in self._lm_id2slot:
            raise KeyError(f"landmark {lm_id} not live")
        k = self._alloc(self._ofree, "observation")
        self._ofree[k] = False
        self.oi[k], self.oj[k] = sp, self._lm_id2slot[lm_id]
        self._plan = None
        self.obs[k] = self._t(obs)
        self.o_sqrt[k] = self._t(sqrt_info)
        self.ow[k] = 1.0

    # ------------------------------------------------------------------
    # device math
    # ------------------------------------------------------------------
    def _graph(self, T, Lm, pvalid, lvalid, idx, bw, ow):
        bi, bj, oi, oj = idx
        blocks = {
            "landmarks": VariableBlock("euclidean", Lm, ~lvalid),
            "poses": VariableBlock(self.kind, T, ~pvalid),
        }
        batches = [
            FactorBatch(
                kind=f"between_{self.kind}",
                slots=("poses", "poses"),
                indices=(bi, bj),
                data={"T_obs": self.T_obs, "sqrt_info": self.b_sqrt},
                loss=L2Loss(),
                weight=bw,
            ),
            FactorBatch(
                kind=self.obs_kind,
                slots=("poses", "landmarks"),
                indices=(oi, oj),
                data={"obs": self.obs, "sqrt_info": self.o_sqrt, **self.obs_extras},
                loss=L2Loss(),
                weight=ow,
            ),
        ]
        return FactorGraph(blocks, batches)

    def _device_state(self):
        """(plan, index tensors, pose validity, landmark validity, free
        vector); the plan rebuilt from the host mirrors when they
        changed."""
        if self._plan is None:
            host_idx = tuple(torch.tensor(a, dtype=torch.int64) for a in (self.bi, self.bj, self.oi, self.oj))
            ones_p = torch.ones(self.window, dtype=torch.bool, device=self.device)
            ones_l = torch.ones(self.lm_slots, dtype=torch.bool, device=self.device)
            plan = dense_plan(self._graph(self.T, self.Lm, ones_p, ones_l, host_idx, self.bw, self.ow))
            self._plan = (plan, tuple(t.to(self.device) for t in host_idx))
            self.plans_built += 1
        if self._lvalid is None:
            self._lvalid = torch.tensor(~self._lm_free, device=self.device)
        pvalid = torch.arange(self.window, device=self.device) < self.count
        lvalid = self._lvalid
        free = torch.cat([lvalid.repeat_interleave(self.lm_dim), pvalid.repeat_interleave(self._d)]).to(self.dtype)
        return (*self._plan, pvalid, lvalid, free)

    def _eta(self, T, Lm):
        ops = _OPS[self.kind]
        return torch.cat([(Lm - self.Lmlin).reshape(-1), ops.log(T @ ops.inv(self.Tlin)).reshape(-1)])

    def _prior_system(self, g, plan, eta, free, exact_info=False):
        """Assembled graph system + the prior, at the current point (grad
        convention: g = -J^T W r from assemble_dense).  ``exact_info``
        removes assemble_dense's unit diagonal on frozen rows:
        marginalization must fold exactly the consumed information, while
        the GN update keeps it so frozen dims solve to exactly 0."""
        H_a, grad_a, _ = assemble_dense(g, plan)
        if exact_info:
            H_a.diagonal().sub_(1.0 - free)
        grad = grad_a - (self.Hp @ eta + self.bp) * free
        H = H_a + self.Hp * free[:, None] * free[None, :]
        return H, grad

    def _gn(self):
        self._gn_steps(*self._device_state())

    def _gn_steps(self, plan, idx, pvalid, lvalid, free):
        """``gn_iters`` GN steps on the device: no host read, no transfer."""
        D, d, ld = self._D, self._d, self.lm_dim
        W, L = self.window, self.lm_slots
        ops = _OPS[self.kind]
        damping = self.damping * torch.eye(D, dtype=self.dtype, device=self.device)
        T, Lm = self.T, self.Lm
        for _ in range(self.gn_iters):
            g = self._graph(T, Lm, pvalid, lvalid, idx, self.bw, self.ow)
            H, grad = self._prior_system(g, plan, self._eta(T, Lm), free)
            dx, _ = torch.linalg.solve_ex(H + damping, grad)
            dx = dx * free
            T, Lm = ops.perturb(T, dx[L * ld :].reshape(W, d)), Lm + dx[: L * ld].reshape(L, ld)
        self.T, self.Lm = T, Lm

    def _eliminate(self, bw, ow, perm, k):
        """Schur-eliminate the first ``k`` dims of the system permuted by
        ``perm`` (a device index); returns (reduced H, reduced -grad) in
        the order of ``perm[k:]``."""
        plan, idx, pvalid, lvalid, free = self._device_state()
        g = self._graph(self.T, self.Lm, pvalid, lvalid, idx, bw, ow)
        H, grad = self._prior_system(g, plan, self._eta(self.T, self.Lm), free, exact_info=True)
        Hm = H[perm][:, perm]
        gm = grad[perm]
        CmI, _ = torch.linalg.inv_ex(Hm[:k, :k])
        B = Hm[k:, :k]
        return Hm[k:, k:] - B @ CmI @ B.T, -(gm[k:] - B @ (CmI @ gm[:k]))

    def _marginalize_oldest(self):
        """Schur-eliminate pose slot 0 (its dims sit at a static offset),
        then shift the pose dims of the prior down one slot."""
        D, d, o = self._D, self._d, self._off_p
        b_adj = ~self._bfree & ((self.bi == 0) | (self.bj == 0))
        o_adj = ~self._ofree & (self.oi == 0)
        b_adj_t = torch.tensor(b_adj, dtype=self.dtype, device=self.device)
        o_adj_t = torch.tensor(o_adj, dtype=self.dtype, device=self.device)
        # pose-0 dims to the front; the rest [landmarks | poses 1..W-1] IS
        # the new layout [landmarks | poses 0..W-2], the last pose slot zeroed
        perm = torch.cat([torch.arange(o, o + d), torch.arange(0, o), torch.arange(o + d, D)]).to(self.device)
        Hp_r, bp_r = self._eliminate(self.bw * b_adj_t, self.ow * o_adj_t, perm, d)
        self.Hp = torch.zeros_like(self.Hp)
        self.bp = torch.zeros_like(self.bp)
        self.Hp[: D - d, : D - d] = Hp_r
        self.bp[: D - d] = bp_r
        self.T = torch.roll(self.T, -1, dims=0)
        # the prior is expressed at the current estimates: rebase them
        self.Tlin = self.T.clone()
        self.Lmlin = self.Lm.clone()
        # consume adjacent factors; shift remaining pose indices down one
        self.bw = self.bw * (1.0 - b_adj_t)
        self.ow = self.ow * (1.0 - o_adj_t)
        self._bfree |= b_adj
        self._ofree |= o_adj
        self.bi[~self._bfree] -= 1
        self.bj[~self._bfree] -= 1
        self.oi[~self._ofree] -= 1
        self._plan = None
        self.count -= 1
        self.first_id += 1

    def retire_landmark(self, lm_id: int):
        """Marginalize a landmark (and its remaining observations) into the
        prior and free its slot for reuse."""
        if lm_id not in self._lm_id2slot:
            raise KeyError(f"landmark {lm_id} not live")
        slot = self._lm_id2slot[lm_id]
        o_adj = ~self._ofree & (self.oj == slot)
        D, ld = self._D, self.lm_dim
        i0 = slot * ld
        perm = np.concatenate([np.arange(i0, i0 + ld), np.arange(0, i0), np.arange(i0 + ld, D)])
        perm_t = torch.tensor(perm, device=self.device)
        o_adj_t = torch.tensor(o_adj, dtype=self.dtype, device=self.device)
        Hp_r, bp_r = self._eliminate(torch.zeros_like(self.bw), self.ow * o_adj_t, perm_t, ld)
        inv_idx = perm_t[ld:]
        self.Hp = torch.zeros_like(self.Hp)
        self.bp = torch.zeros_like(self.bp)
        self.Hp[inv_idx[:, None], inv_idx[None, :]] = Hp_r  # unique positions
        self.bp[inv_idx] = bp_r
        self.Tlin = self.T.clone()
        self.Lmlin = self.Lm.clone()
        self.ow = self.ow * (1.0 - o_adj_t)
        self._ofree |= o_adj
        self._plan = None
        self._lm_free[slot] = True
        self._lvalid = None
        del self._lm_id2slot[lm_id]
        self._lm_slot2id[slot] = -1
        safe = self._t(self._lm_safe)
        self.Lm[slot] = safe
        self.Lmlin[slot] = safe

    def _evict_unobserved(self):
        """Retire the oldest live landmark with no remaining observations;
        if every slot still carries live observations, retire the oldest
        landmark outright — retire_landmark consumes its remaining
        observations into the prior (frozen linearization), the standard
        VIO treatment of features evicted while still tracked."""
        live_obs_slots = set(self.oj[~self._ofree].tolist())
        for lm_id in sorted(self._lm_id2slot):
            if self._lm_id2slot[lm_id] not in live_obs_slots:
                self.retire_landmark(lm_id)
                return
        self.retire_landmark(min(self._lm_id2slot))

    # ------------------------------------------------------------------
    # the per-frame entry point
    # ------------------------------------------------------------------
    def update(self):
        """One window GN solve; returns the (count, m, m) pose estimates,
        oldest first (the one host read of a frame)."""
        self._gn()
        return self.poses()


__all__ = ["FixedLagSmoother", "FixedLagLandmarkSmoother"]
