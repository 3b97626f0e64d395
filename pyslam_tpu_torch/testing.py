"""Helpers for the tests and the smoke script: a small SE(3) pose graph
that takes every branch of the SE(3) assembly (``se3_stress_graph``, for
the ``ell_assemble`` kernel), and ``run_ranks``, which runs a function on
several ranks of a process group, one spawned process each (for
``dist/``).

``se3_stress_graph`` starts from ``synth.se3_sphere`` and adds what a plain
sphere never shows:

* a frozen pose in the middle, beside the anchored pose 0;
* a batch of ``prior_se3`` factors (L2), one of them padding (weight 0);
* a second ``between_se3`` batch of special-angle factors with a general
  6x6 ``sqrt_info`` and one padding factor.  Their error rotations
  log(T_est T_obs^-1) are exactly 0, below the Taylor threshold 1e-4 of
  ``lie/so3.py``, and within its near-pi band of 1e-3 (two axes, one with
  mixed signs; no axis component is near 0, where the square root that
  recovers the axis amplifies rounding noise in any implementation).

Everything is made with numpy in f64 from the seed and then cast, so that
two packages or two devices get the same problem.
"""

from __future__ import annotations

import math
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ._device import resolve_device
from .graph.core import FactorBatch, FactorGraph, VariableBlock
from .io import synth
from .lie import se3
from .losses import L2Loss

# error rotations of the special-angle factors: (angle, axis); the first
# pair of poses is given identity rotations and an exact-zero angle
_SPECIAL = (
    (0.0, (1.0, 0.0, 0.0)),
    (5e-5, (0.3, -0.5, 0.8)),
    (math.pi - 5e-4, (1.0, 2.0, 3.0)),
    (math.pi - 2e-4, (-0.5, 0.7, 0.5)),
    (0.7, (0.2, 0.9, -0.4)),  # the padding factor
)


def _exp(xi):
    return se3.exp(torch.from_numpy(np.asarray(xi, np.float64))).numpy()


def se3_stress_arrays(n_poses=60, seed=11):
    """The graph as numpy arrays (f64): ``blocks`` and ``batches`` in the
    form ``graph_from_numpy`` takes, without losses."""
    if n_poses < 24:
        raise ValueError("se3_stress_graph needs at least 24 poses")
    data = synth.se3_sphere(n_poses=n_poses, seed=seed)
    rng = np.random.default_rng(seed)
    # off the odometry chain, whose residuals are rounding noise at the
    # start: a robust weight of such a residual has no stable digits
    T0 = _exp(rng.normal(scale=0.05, size=(n_poses, 6))) @ np.asarray(data.T_init, np.float64)
    const = np.zeros(n_poses, bool)
    const[[0, n_poses // 2]] = True
    # identity rotations for the exact-zero factor
    T0[3, :3, :3] = np.eye(3)
    T0[9, :3, :3] = np.eye(3)

    pairs = np.array([[3, 9], [5, 14], [7, 18], [11, 21], [13, 2]], np.int64)
    T_obs = np.empty((len(pairs), 4, 4))
    for n, ((i, j), (angle, axis)) in enumerate(zip(pairs, _SPECIAL)):
        axis = np.asarray(axis) / np.linalg.norm(axis)
        xi = np.concatenate([rng.normal(scale=0.2, size=3), angle * axis])
        T_est = T0[j] @ np.linalg.inv(T0[i])
        T_obs[n] = np.linalg.inv(_exp(xi)) @ T_est if angle else np.linalg.inv(_exp(xi))
    T_obs[0, :3, :3] = np.eye(3)  # exactly, whatever exp and inv rounded
    special_info = np.eye(6) + 0.3 * rng.normal(size=(len(pairs), 6, 6))

    prior_idx = np.array([5, 17, n_poses // 2, n_poses - 1], np.int64)
    blocks = {"poses": dict(kind="se3", values=T0, const_mask=const)}
    batches = [
        dict(kind="between_se3", slots=("poses", "poses"),
             indices=[np.asarray(data.edges_i, np.int64), np.asarray(data.edges_j, np.int64)],
             data={"T_obs": np.asarray(data.T_meas, np.float64), "sqrt_info": np.asarray(data.sqrt_info, np.float64)},
             weight=np.ones(len(data.edges_i))),
        dict(kind="prior_se3", slots=("poses",), indices=[prior_idx],
             data={"T_obs": np.asarray(data.T_gt, np.float64)[prior_idx],
                   "sqrt_info": np.broadcast_to(np.eye(6) * 10.0, (len(prior_idx), 6, 6)).copy()},
             weight=np.array([1.0, 1.0, 0.0, 1.0])),
        dict(kind="between_se3", slots=("poses", "poses"), indices=[pairs[:, 0], pairs[:, 1]],
             data={"T_obs": T_obs, "sqrt_info": special_info},
             weight=np.array([1.0, 1.0, 1.0, 1.0, 0.0])),
    ]
    return blocks, batches


def se3_stress_graph(n_poses=60, seed=11, loss=None, dtype=torch.float64, device=None) -> FactorGraph:
    """The stress graph on ``device`` (None: the package's default).  ``loss``
    (default L2) is the loss of both ``between_se3`` batches; the priors
    are L2."""
    device = resolve_device(device)
    loss = loss if loss is not None else L2Loss()
    blocks, batches = se3_stress_arrays(n_poses, seed)

    def tensor(a):
        return torch.tensor(a, dtype=dtype, device=device)

    b = blocks["poses"]
    t_blocks = {"poses": VariableBlock.create(b["kind"], tensor(b["values"]), torch.tensor(b["const_mask"], device=device))}
    t_batches = [
        FactorBatch.create(
            kind=fb["kind"], slots=fb["slots"], indices=fb["indices"],
            data={k: tensor(v) for k, v in fb["data"].items()},
            loss=L2Loss() if fb["kind"] == "prior_se3" else loss, weight=tensor(fb["weight"]),
        )
        for fb in batches
    ]
    return FactorGraph(t_blocks, t_batches)


# --------------------------------------------------------------------------
# Several ranks in one machine, for the tests and the smoke script of dist/
# --------------------------------------------------------------------------


def _rank_main(rank, world_size, store_dir, backend, device, fn, args):
    from .dist.mesh import init_distributed, make_mesh

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # the ranks share the machine's cores
    try:
        init_distributed(f"file://{os.path.join(store_dir, 'store')}", world_size, rank, backend=backend,
                         device=device, timeout_s=300.0)
        try:
            out = fn(make_mesh(device=device), *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(store_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(store_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world_size: int, store_dir, args=(), backend: str = "gloo", device="cpu", timeout_s: float = 600.0):
    """Run ``fn(mesh, *args)`` in ``world_size`` new processes (spawned),
    one rank each, over a ``file://`` store in the empty directory
    ``store_dir``; return the ranks' results in rank order.  ``fn`` must be
    importable by name and its result picklable.  The processes are killed
    if they have not all ended after ``timeout_s``; a failed rank raises
    with its traceback."""
    store_dir = str(store_dir)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world_size, store_dir, backend, device, fn, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10.0)
    errors = []
    for r in range(world_size):
        path = os.path.join(store_dir, f"error_{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if alive or errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"run_ranks: {len(alive)} of {world_size} ranks killed after {timeout_s} s, exit codes "
                           f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    out = []
    for r in range(world_size):
        with open(os.path.join(store_dir, f"result_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
