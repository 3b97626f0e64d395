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

``se3_pair_graph`` gives several factors to one pose pair, in one batch in
both directions and across batches, beside priors.

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


def se3_pair_arrays(n_poses=64, seed=5):
    """A pose graph whose factors share pose pairs, as numpy arrays in the
    form of ``se3_stress_arrays``: ``se3_sphere``'s edges, then in the same
    batch every loop closure again in the other direction (the measurement
    inverted) and the first three loop closures again as they are; a batch
    of priors; a second ``between_se3`` batch on the first five odometry
    pairs, reversed.  A slot then sums several blocks of one factor batch in
    both directions and blocks of two batches."""
    data = synth.se3_sphere(n_poses=n_poses, seed=seed)
    rng = np.random.default_rng(seed)
    T0 = _exp(rng.normal(scale=0.05, size=(n_poses, 6))) @ np.asarray(data.T_init, np.float64)
    const = np.zeros(n_poses, bool)
    const[0] = True
    i, j = np.asarray(data.edges_i, np.int64), np.asarray(data.edges_j, np.int64)
    T, S = np.asarray(data.T_meas, np.float64), np.asarray(data.sqrt_info, np.float64)
    loops = np.nonzero(np.abs(j - i) > 1)[0]
    again = loops[:3]
    first = dict(i=np.concatenate([i, j[loops], i[again]]), j=np.concatenate([j, i[loops], j[again]]),
                 T=np.concatenate([T, np.linalg.inv(T[loops]), T[again]]), S=np.concatenate([S, S[loops], S[again]]))
    prior_idx = np.array([3, n_poses // 2], np.int64)
    blocks = {"poses": dict(kind="se3", values=T0, const_mask=const)}
    batches = [
        dict(kind="between_se3", slots=("poses", "poses"), indices=[first["i"], first["j"]],
             data={"T_obs": first["T"], "sqrt_info": first["S"]}, weight=np.ones(len(first["i"]))),
        dict(kind="prior_se3", slots=("poses",), indices=[prior_idx],
             data={"T_obs": np.asarray(data.T_gt, np.float64)[prior_idx],
                   "sqrt_info": np.broadcast_to(np.eye(6) * 10.0, (len(prior_idx), 6, 6)).copy()},
             weight=np.ones(len(prior_idx))),
        dict(kind="between_se3", slots=("poses", "poses"), indices=[j[:5], i[:5]],
             data={"T_obs": np.linalg.inv(T[:5]), "sqrt_info": S[:5]}, weight=np.ones(5)),
    ]
    return blocks, batches


def se3_stress_graph(n_poses=60, seed=11, loss=None, dtype=torch.float64, device=None) -> FactorGraph:
    """The stress graph on ``device`` (None: the package's default).  ``loss``
    (default L2) is the loss of both ``between_se3`` batches; the priors
    are L2."""
    return _graph_of(se3_stress_arrays(n_poses, seed), loss, dtype, device)


def se3_pair_graph(n_poses=64, seed=5, loss=None, dtype=torch.float64, device=None) -> FactorGraph:
    """``se3_pair_arrays`` as a graph, the losses as ``se3_stress_graph``
    gives them."""
    return _graph_of(se3_pair_arrays(n_poses, seed), loss, dtype, device)


def _graph_of(arrays, loss, dtype, device) -> FactorGraph:
    device = resolve_device(device)
    loss = loss if loss is not None else L2Loss()
    blocks, batches = arrays

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


# --------------------------------------------------------------------------
# Streams for the online smoothers
# --------------------------------------------------------------------------
# The feeds below touch only the smoothers' common API, so one function
# drives the port's smoother and the reference's alike.


def fixed_lag_frames(sm, data, n):
    """Stream a pose graph (``synth.PoseGraphData``) into a
    ``FixedLagSmoother``, one frame a step: odometry to pose t, then every
    loop closure ending at t whose older pose is still in the window (the
    feed of ``tests/test_fixed_lag.py``), then ``update()``.  Yields (t, the
    window's poses) for t = 1 .. n-1."""
    by_j = {}
    for k, (i, j) in enumerate(zip(map(int, data.edges_i), map(int, data.edges_j))):
        by_j.setdefault(j, []).append((k, i))
    chain = {j: k for j, ks in by_j.items() for k, i in ks if i == j - 1}
    sm.add_pose(data.T_init[0])
    for t in range(1, n):
        k = chain[t]
        sm.add_odometry(data.T_meas[k], data.sqrt_info[k])
        for k2, i in by_j.get(t, []):
            if i != t - 1 and i >= sm.first_id:
                sm.add_factor(i, t, data.T_meas[k2], data.sqrt_info[k2])
        yield t, sm.update()


def _leaving(sm, frames, n):
    """Run ``frames`` to the end: ({absolute id: pose as it left the
    window}, the last window).  A full window after frame t loses its
    oldest pose at frame t + 1."""
    left, est = {}, None
    for t, est in frames:
        if sm.count == sm.window and t + 1 < n:
            left[sm.first_id] = est[0]
    return left, est


def drive_fixed_lag(sm, data, n):
    """``fixed_lag_frames`` to the end; returns ({absolute id: pose as it
    left the window}, the last window)."""
    return _leaving(sm, fixed_lag_frames(sm, data, n), n)


def fixed_lag_landmark_frames(sm, data, n, retired=None):
    """Stream 2D landmark SLAM (``synth.LandmarkSLAM2DData``) into a
    ``FixedLagLandmarkSmoother``, one frame a step: the pose's odometry,
    then its observations in order, a landmark added at its first
    observation (``lm_init``) and the observations of an evicted landmark
    dropped, then ``update()``.  Yields (t, the window's poses) for t =
    1 .. n-1; every retirement (landmark id, value at retirement) is
    appended to ``retired``."""
    chain = {int(j): k for k, (i, j) in enumerate(zip(data.edges_i, data.edges_j)) if int(i) == int(j) - 1}
    obs_by_pose = {}
    for k, pi in enumerate(data.obs_pose):
        obs_by_pose.setdefault(int(pi), []).append(k)
    lm_added = {}
    retired = [] if retired is None else retired
    retire = sm.retire_landmark

    def recorded(lm_id):
        retired.append((lm_id, np.asarray(sm.landmark(lm_id))))
        retire(lm_id)

    def feed(t):
        for k in obs_by_pose.get(t, []):
            lj = int(data.obs_lm[k])
            if lj not in lm_added:
                lm_added[lj] = sm.add_landmark(data.lm_init[lj])
            if lm_added[lj] in sm._lm_id2slot:
                sm.add_observation(t, lm_added[lj], data.obs[k], data.obs_sqrt_info[k])

    sm.retire_landmark = recorded
    try:
        sm.add_pose(data.T_init[0])
        feed(0)
        for t in range(1, n):
            sm.add_odometry(data.T_meas[chain[t]], data.sqrt_info[chain[t]])
            feed(t)
            yield t, sm.update()
    finally:
        del sm.retire_landmark


def drive_fixed_lag_landmarks(sm, data, n):
    """``fixed_lag_landmark_frames`` to the end; returns (poses as they left
    the window, the last window, the retirements [(landmark id, value at
    retirement)] in order)."""
    retired = []
    left, last = _leaving(sm, fixed_lag_landmark_frames(sm, data, n, retired), n)
    return left, last, retired


def window_trajectory(left, last, n):
    """(n, m, m): every pose as it left the window, then the last window."""
    out = np.stack([left[i] for i in range(n - len(last))] + list(last))
    assert out.shape[0] == n
    return out


def incremental_updates(sm, data, every):
    """Stream a pose graph into an ``IncrementalSmoother``: poses at the
    odometry prediction from the latest estimate, each loop closure (in
    edge order) once both its poses exist, ``update()`` after every
    ``every`` new poses.  Yields the (chi2, LM iterations) of each update."""
    n = data.T_init.shape[0]
    n_odo = n - 1
    if not (np.asarray(data.edges_i[:n_odo]) == np.arange(n_odo)).all():
        raise ValueError("the first n - 1 edges must be the odometry chain")
    loops = list(range(n_odo, len(data.edges_i)))
    for upto in range(every, n + 1, every):
        while sm.n < upto:
            i = sm.n
            if i == 0:
                sm.add_pose(data.T_init[0])
            else:
                sm.add_pose(data.T_meas[i - 1] @ sm.poses()[i - 1])
                sm.add_between(i - 1, i, data.T_meas[i - 1], data.sqrt_info[i - 1])
        later = []
        for e in loops:
            i, j = int(data.edges_i[e]), int(data.edges_j[e])
            if max(i, j) < upto:
                sm.add_between(i, j, data.T_meas[e], data.sqrt_info[e])
            else:
                later.append(e)
        loops = later
        _, info = sm.update()
        yield float(info.chi2), int(info.iterations)


def drive_incremental(sm, data, every):
    """``incremental_updates`` to the end: [(chi2, LM iterations)]."""
    return list(incremental_updates(sm, data, every))


def drive_incremental_landmarks(sm, data, update_every, keep_window=None):
    """Stream 2-D bearing-range landmark SLAM (``synth.landmark_slam_2d``)
    into an ``IncrementalSmoother`` built with ``obs_kind``: poses at the
    odometry prediction, each landmark added at its first observation from
    the latest estimate, ``update()`` every ``update_every`` poses and at
    the last; with ``keep_window``, ``marginalize_oldest(keep_window)``
    after an update once more than ``keep_window + 4`` poses live.  Returns
    the (chi2, LM iterations) of each update."""
    lm_id, obs_by_pose, ups = {}, {}, []
    for m in range(len(data.obs_pose)):
        obs_by_pose.setdefault(int(data.obs_pose[m]), []).append(m)
    n = len(data.T_init)
    prev = None
    for k in range(n):
        if k == 0:
            prev = sm.add_pose(data.T_init[0])
        else:
            cur = sm.add_pose(data.T_meas[k - 1] @ sm.poses()[prev])
            sm.add_between(prev, cur, data.T_meas[k - 1], data.sqrt_info[k - 1])
            prev = cur
        for m in obs_by_pose.get(k, []):
            lj = int(data.obs_lm[m])
            if lj not in lm_id:
                b, r = data.obs[m]
                p_local = np.array([r * np.cos(b), r * np.sin(b)])
                Tk = sm.poses()[prev]
                lm_id[lj] = sm.add_landmark(Tk[:2, :2].T @ (p_local - Tk[:2, 2]))
            sm.add_observation(prev, lm_id[lj], data.obs[m], data.obs_sqrt_info[m])
        if k % update_every == 0 or k == n - 1:
            _, info = sm.update()
            ups.append((float(info.chi2), int(info.iterations)))
            if keep_window and sm.n > keep_window + 4:
                sm.marginalize_oldest(keep_window)
                prev = sm.n - 1
    return ups


def vio_sliding_window(data, T_meas, window=5, max_iters=25, dtype=torch.float64, device=None, on_keyframe=None):
    """``examples/vio_sliding_window.py``'s estimator on the port: each
    keyframe appends its (pose, velocity, bias) triple, the preintegrated
    IMU factor of its interval, a bias random walk and a pose prior
    (``T_meas``, 2 mm / 2 mrad), runs LM (``max_iters``) through
    ``solver.solve`` and, past ``window`` keyframes, ``marginalize``s the
    oldest triple into a dense prior.  Every interval is preintegrated once
    up front in one batched recursion (``imu._preintegrate_batched``) and
    its covariances come to the host in one read, outside the per-keyframe
    loop.  ``on_keyframe(k, graph, info)`` is called after each keyframe.
    Returns (newest-pose error per keyframe, chi2 per keyframe, LM
    iterations per keyframe, the final window graph)."""
    from . import imu
    from .graph import marginalize
    from .solver import Options, solve

    device = resolve_device(device)
    n = data.T_gt.shape[0]
    f64 = torch.float64
    omega, accel, dts = imu._padded_intervals(data.omega, data.accel, data.dts)
    z = torch.zeros((n - 1, 3), dtype=f64, device=device)
    pim = imu._preintegrate_batched(*(torch.tensor(x, dtype=f64, device=device) for x in (omega, accel, dts)), z, z,
                                    1.7e-4, 2.0e-3)
    S = torch.tensor(imu._sqrt_info_host(pim.cov.cpu().numpy(), 1e-12), dtype=dtype, device=device)
    pim_data = {k: getattr(pim, k).to(dtype) for k in imu._PIM_DATA}
    T_meas_t = torch.tensor(np.asarray(T_meas), dtype=dtype, device=device)
    T_gt = torch.tensor(np.asarray(data.T_gt), dtype=dtype, device=device)
    gravity = torch.tensor(np.asarray(data.gravity), dtype=dtype, device=device)[None]
    Spp = torch.tensor(np.diag([1 / 2e-3] * 6), dtype=dtype, device=device)[None]
    walk = torch.tensor(np.eye(6) / (1e-3 * np.sqrt(0.5)), dtype=dtype, device=device)[None]
    zero6 = torch.zeros((1, 6), dtype=dtype, device=device)

    def pose_prior(k_local, k):
        return FactorBatch.create("prior_se3", slots=("poses",), indices=(np.array([k_local]),),
                                  data={"T_obs": T_meas_t[k : k + 1], "sqrt_info": Spp}, loss=L2Loss())

    def append(block, value):
        return VariableBlock(block.kind, torch.cat([block.values, value[None]]),
                             torch.cat([block.const_mask, torch.zeros(1, dtype=torch.bool, device=device)]))

    blocks = {"poses": VariableBlock.create("se3", T_meas_t[:1].clone()),
              "vels": VariableBlock.create("euclidean", torch.zeros((1, 3), dtype=dtype, device=device)),
              "biases": VariableBlock.create("euclidean", torch.zeros((1, 6), dtype=dtype, device=device))}
    g = FactorGraph(blocks, [pose_prior(0, 0)])
    errs, chi2s, iters = [], [], []
    for k in range(1, n):
        imu_data = {key: v[k - 1 : k] for key, v in pim_data.items()}
        imu_data["sqrt_info"] = S[k - 1 : k]
        imu_data["gravity"] = gravity
        w = g.blocks["poses"].n
        blocks = dict(g.blocks)
        blocks["poses"] = append(blocks["poses"], T_meas_t[k])
        blocks["vels"] = append(blocks["vels"], blocks["vels"].values[-1])
        blocks["biases"] = append(blocks["biases"], blocks["biases"].values[-1])
        batches = list(g.batches) + [
            FactorBatch.create("imu_preintegrated", slots=("poses", "poses", "vels", "vels", "biases"),
                               indices=tuple(np.array([i]) for i in (w - 1, w, w - 1, w, w - 1)), data=imu_data,
                               loss=L2Loss()),
            FactorBatch.create("between_euclidean", slots=("biases", "biases"),
                               indices=(np.array([w - 1]), np.array([w])), data={"delta": zero6, "sqrt_info": walk},
                               loss=L2Loss()),
            pose_prior(w, k)]
        g, info = solve(FactorGraph(blocks, batches), Options(method="lm", max_iters=max_iters))
        if g.blocks["poses"].n > window:
            g = marginalize(g, {"poses": [0], "vels": [0], "biases": [0]})
        err = torch.linalg.norm(se3.log(T_gt[k] @ se3.inv(g.blocks["poses"].values[-1])))
        e, c = torch.stack([err, info.chi2.to(err.dtype)]).tolist()  # one read
        errs.append(e)
        chi2s.append(c)
        iters.append(info.iterations)
        if on_keyframe is not None:
            on_keyframe(k, g, info)
    return errs, chi2s, iters, g


# --------------------------------------------------------------------------
# Synthetic VO frames (numpy, copied from the reference's benchmark and
# tests: ``bench/vo_overlap.py`` and ``tests/test_pipelines.py``)
# --------------------------------------------------------------------------

VO_W, VO_H, VO_Z0 = 640, 480, 4.0
VO_CAM = dict(cu=319.5, cv=239.5, fu=525.0, fv=525.0, w=VO_W, h=VO_H)


def vo_tex(x, y):
    """``bench/vo_overlap.py``'s world texture."""
    return (
        0.5
        + 0.2 * np.sin(2.5 * x) * np.cos(1.8 * y)
        + 0.15 * np.sin(0.9 * x + 1.3 * y)
        + 0.1 * np.cos(5.1 * x - 2.2 * y)
    )


def vo_render(t):
    """uint8 VGA frame and float32 depth of a camera at world position t
    (identity rotation) looking at the textured plane z = 4."""
    u, v = np.meshgrid(np.arange(VO_W), np.arange(VO_H), indexing="xy")
    zc = VO_Z0 - t[2]
    xw = (u - VO_CAM["cu"]) / VO_CAM["fu"] * zc + t[0]
    yw = (v - VO_CAM["cv"]) / VO_CAM["fv"] * zc + t[1]
    im = np.clip(vo_tex(xw, yw), 0.0, 1.0)
    return (im * 255).astype(np.uint8), np.full((VO_H, VO_W), zc, np.float32)


def vo_frames(n):
    """``bench/vo_overlap.py::make_frames``: n (uint8 frame, depth) pairs
    along t_k = [0.02 k, 0.01 sin(k / 2), 0]."""
    return [vo_render(np.array([0.02 * k, 0.01 * np.sin(k / 2), 0.0])) for k in range(n)]


def vo_truth(n):
    """Camera-from-world poses of ``vo_frames(n)``: [I | -t_k]."""
    T = np.tile(np.eye(4), (n, 1, 1))
    for k in range(n):
        T[k, :3, 3] = -np.array([0.02 * k, 0.01 * np.sin(k / 2), 0.0])
    return T


PLANE_Z0 = 4.0
PLANE_CAM = dict(cu=31.5, cv=23.5, fu=100.0, fv=100.0, w=64, h=48)


def plane_tex(x, y):
    """``tests/test_pipelines.py``'s smooth world texture."""
    return 0.5 + 0.25 * np.sin(2.5 * x) * np.cos(1.8 * y) + 0.15 * np.sin(0.9 * x + 1.3 * y)


def render_rgbd(t, cam=PLANE_CAM):
    """Image and depth seen by a camera at world position t (identity
    rotation) of the plane z = 4 (``tests/test_pipelines.py``; ``cam``
    ``VO_CAM`` gives the same scene at VGA)."""
    u, v = np.meshgrid(np.arange(cam["w"]), np.arange(cam["h"]), indexing="xy")
    zc = PLANE_Z0 - t[2]
    xw = (u - cam["cu"]) / cam["fu"] * zc + t[0]
    yw = (v - cam["cv"]) / cam["fv"] * zc + t[1]
    return plane_tex(xw, yw), np.full((cam["h"], cam["w"]), zc)


def render_stereo(t, b=0.3, cam=PLANE_CAM):
    """Left / right pair and the true disparity of a camera at world
    position t, the right camera offset +b along x."""
    im_left, depth = render_rgbd(t, cam)
    im_right, _ = render_rgbd(t + np.array([b, 0.0, 0.0]), cam)
    return im_left, im_right, cam["fu"] * b / depth


def matcher_texture(shape, seed=1):
    """The texture of the reference's on-device matcher test
    (``tests/test_pipelines.py``, ``test_stereo_pipeline_with_tpu_matcher``):
    uniform noise in [0.2, 0.8] of ``shape``, smoothed by a 3-tap box along
    the rows."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0.2, 0.8, shape)
    k = np.ones(3) / 3
    return np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, tex)


VO_STEREO_PAD = 96  # texels around the view of a camera at t = 0


def noise_render(tex, t):
    """uint8 VGA frame of a camera at world position t (identity rotation)
    looking at the plane z = 4 that carries ``tex``: one texel a pixel of
    the camera at t = 0, bilinear between texels, quantized as
    ``vo_render`` quantizes."""
    u, v = np.meshgrid(np.arange(VO_W), np.arange(VO_H), indexing="xy")
    zc = VO_Z0 - t[2]
    xw = (u - VO_CAM["cu"]) / VO_CAM["fu"] * zc + t[0]
    yw = (v - VO_CAM["cv"]) / VO_CAM["fv"] * zc + t[1]
    x = xw * VO_CAM["fu"] / VO_Z0 + VO_CAM["cu"] + VO_STEREO_PAD
    y = yw * VO_CAM["fv"] / VO_Z0 + VO_CAM["cv"] + VO_STEREO_PAD
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    fx, fy = x - x0, y - y0
    im = ((1 - fy) * ((1 - fx) * tex[y0, x0] + fx * tex[y0, x0 + 1])
          + fy * ((1 - fx) * tex[y0 + 1, x0] + fx * tex[y0 + 1, x0 + 1]))
    return (np.clip(im, 0.0, 1.0) * 255).astype(np.uint8)


def vo_stereo_frames(n, b=0.3):
    """n stereo triples (uint8 left, uint8 right, true disparity) along
    ``vo_frames``' path: the benchmark's VGA camera and plane, textured
    with ``matcher_texture`` (the benchmark's smooth texture leaves the
    block matcher too little texture at VGA), the right camera offset +b
    along x. Ground truth: ``vo_truth(n)``."""
    tex = matcher_texture((VO_H + 2 * VO_STEREO_PAD, VO_W + 2 * VO_STEREO_PAD))
    out = []
    for k in range(n):
        t = np.array([0.02 * k, 0.01 * np.sin(k / 2), 0.0])
        disp = np.full((VO_H, VO_W), VO_CAM["fu"] * b / (VO_Z0 - t[2]))
        out.append((noise_render(tex, t), noise_render(tex, t + np.array([b, 0.0, 0.0])), disp))
    return out


def exposure_ramp(im, k):
    """Frame k of an exposure ramp: gain 1 + 0.05 k, bias 0.02 k, clipped to
    [0, 2]; a uint8 frame is normalized to [0, 1] first (``/ 255.0``)."""
    if im.dtype == np.uint8:
        im = im / 255.0
    return np.clip((1.0 + 0.05 * k) * im + 0.02 * k, 0.0, 2.0)


# --------------------------------------------------------------------------
# examples/stereo_slam.py on the port
# --------------------------------------------------------------------------

SLAM_CAM = dict(cu=320.0, cv=240.0, fu=500.0, fv=500.0, b=0.3, w=640, h=480)


def stereo_slam_world(n_frames=40, seed=0, n_pts=4000, radius=8.0, pix_noise=0.3, max_pts=300):
    """``examples/stereo_slam.py``'s data: points on a cylinder around a
    circular trajectory of stereo frames (camera-from-world ``gt`` (n, 4,
    4)), and each frame's visible observations (ids, [uL, vL, d] + noise),
    projected in float64 on the host. Returns (world, gt, frames)."""
    from .sensors import StereoCamera

    cam = StereoCamera(**SLAM_CAM)
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    r = radius + rng.uniform(1.0, 4.0, n_pts)
    z = rng.uniform(-2.0, 2.0, n_pts)
    world = np.stack([r * np.cos(ang), r * np.sin(ang), z], axis=-1)
    gt = []
    for k in range(n_frames):
        a = 2 * np.pi * k / n_frames
        center = np.array([radius * np.cos(a), radius * np.sin(a), 0.0])
        zc = np.array([-np.sin(a), np.cos(a), 0.0])  # direction of travel
        yc = np.array([0.0, 0.0, -1.0])
        R_wc = np.stack([np.cross(yc, zc), yc, zc], axis=-1)
        T = np.eye(4)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ center
        gt.append(T)
    frames = []
    for T in gt:
        pc = world @ T[:3, :3].T + T[:3, 3]
        obs = cam.project(torch.from_numpy(pc)).numpy()
        vis = cam.is_valid_measurement(torch.from_numpy(obs)).numpy() & (pc[:, 2] > 0.5)
        ids = np.nonzero(vis)[0]
        if len(ids) > max_pts:
            ids = rng.choice(ids, max_pts, replace=False)
        frames.append((ids, obs[ids] + rng.normal(0, pix_noise, (len(ids), 3))))
    return world, np.stack(gt), frames


def stereo_slam(world, gt, frames, dtype=torch.float32, device=None, ransac_iters=256, samples=None, stages=None):
    """``examples/stereo_slam.py``'s pipeline on the port, in ``dtype`` on
    ``device``: the RANSAC odometry chain (``FrameToFrameRANSAC``), loop
    closures between revisited poses measured the same way, the pose graph
    (between_se3, Cauchy(2), LM 50, ``solver.solve``), then joint SLAM of
    every observation and the pose graph's factors through ``solve_auto``
    (LM 30). ``samples``, when given, maps a match count N to the (M, 3)
    samples that a RANSAC call over N matches scores in place of its own
    draw (the reference's draw depends on N alone). ``stages``, when
    given, maps a stage name ("odometry",
    "pose_graph", "joint") to a wrapper ``fn(name, run) -> run()`` around
    it. Returns a dict of the three ATEs (m), the edges and loop closures,
    the LM iterations, the landmark and observation counts."""
    from .eval import TrajectoryMetrics
    from .losses import CauchyLoss
    from .pipelines.ransac import FrameToFrameRANSAC
    from .sensors import StereoCamera
    from .solver import Options, solve, solve_auto

    device = resolve_device(device)
    cam = StereoCamera(**SLAM_CAM)
    npdt = torch.empty((), dtype=dtype).numpy().dtype
    n = len(gt)
    ransac = FrameToFrameRANSAC(cam, num_iters=ransac_iters, inlier_thresh=2.0, device=device)
    stage = stages or {}

    def run(name, fn):
        return stage[name](name, fn) if name in stage else fn()

    def relative(a, b):
        (ids_a, obs_a), (ids_b, obs_b) = frames[a], frames[b]
        common, ia, ib = np.intersect1d(ids_a, ids_b, return_indices=True)
        if len(common) < 12:
            return None
        T, mask = ransac.compute_transform(obs_a[ia].astype(npdt), obs_b[ib].astype(npdt),
                                           samples=None if samples is None else samples[len(common)])
        if mask.sum() < 10:
            return None
        return T.mat.cpu().numpy()

    def front():
        edges, est = [], [gt[0]]
        for k in range(1, n):
            T_rel = relative(k - 1, k)
            if T_rel is None:
                raise RuntimeError(f"stereo_slam: odometry break at frame {k}")
            edges.append((k - 1, k, T_rel))
            est.append(T_rel @ est[-1])
        loops = 0
        for k in range(n):
            for j in range(k + 5, n):
                if np.linalg.norm(np.linalg.inv(gt[k])[:3, 3] - np.linalg.inv(gt[j])[:3, 3]) < 2.5:
                    T_rel = relative(k, j)
                    if T_rel is not None:
                        edges.append((k, j, T_rel))
                        loops += 1
        return edges, np.stack(est), loops

    def ate(T_c_w):
        return TrajectoryMetrics(np.linalg.inv(gt), np.linalg.inv(T_c_w), device=device).armse("trans").item()

    edges, est, loops = run("odometry", front)
    const = np.zeros(n, bool)
    const[0] = True

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(device)

    between = FactorBatch.create(
        kind="between_se3", slots=("poses", "poses"),
        indices=(np.array([e[0] for e in edges]), np.array([e[1] for e in edges])),
        data={"T_obs": t(np.stack([e[2] for e in edges])),
              "sqrt_info": t(np.eye(6) * 10.0).expand(len(edges), 6, 6).contiguous()},
        loss=CauchyLoss(2.0))
    graph = FactorGraph({"poses": VariableBlock.create("se3", t(est), t(const, torch.bool))}, [between])
    solved, info = run("pose_graph", lambda: solve(graph, Options(method="lm", max_iters=50)))
    opt = solved.blocks["poses"].values.cpu().numpy()

    obs_cam = np.concatenate([np.full(len(ids), k, np.int64) for k, (ids, _) in enumerate(frames)])
    obs_world = np.concatenate([ids for ids, _ in frames])
    obs_uvd = np.concatenate([obs for _, obs in frames])
    first_obs = {}
    for k, (ids, obs) in enumerate(frames):
        for row, wid in enumerate(ids):
            first_obs.setdefault(int(wid), (k, obs[row]))
    used = np.unique(obs_world)
    remap = np.full(world.shape[0], -1, np.int64)
    remap[used] = np.arange(len(used))
    firsts = [first_obs[int(w)] for w in used]
    p_cam = cam.triangulate(torch.from_numpy(np.stack([o for _, o in firsts]).astype(npdt))).numpy()
    T_w_c = np.linalg.inv(opt[[k for k, _ in firsts]])
    lm_init = (np.einsum("nij,nj->ni", T_w_c[:, :3, :3], p_cam) + T_w_c[:, :3, 3]).astype(npdt)
    slam = FactorGraph(
        {"poses": VariableBlock.create("se3", t(opt), t(const, torch.bool)),
         "landmarks": VariableBlock.create("euclidean", t(lm_init))},
        [FactorBatch.create(kind="reprojection", slots=("poses", "landmarks"), indices=(obs_cam, remap[obs_world]),
                            data={"obs": t(obs_uvd), "sqrt_info": t(np.eye(3)), "camera": cam},
                            loss=CauchyLoss(3.0)),
         between])
    refined, info2 = run("joint", lambda: solve_auto(slam, Options(method="lm", max_iters=30)))
    opt2 = refined.blocks["poses"].values.cpu().numpy()
    return dict(ate_odometry=ate(est), ate_pose_graph=ate(opt), ate_joint=ate(opt2), edges=len(edges), loops=loops,
                pose_graph_iterations=info.iterations, joint_iterations=info2.iterations, landmarks=len(used),
                observations=len(obs_cam))
