"""The structure dispatch (``route_auto``, ``solve_auto``) and the batched
fleet solve (``solve_batched``) of the torch port against the JAX
reference, in f64 on the CPU.

* ``route_auto``: the same route name as the reference on every
  single-chip graph of the reference's route tests (shape-only stand-ins at
  Venice / Dubrovnik scale, and real graphs carried across with
  ``graph_from_numpy``; the large ones are built, never solved).  The one
  pinned difference: a graph whose observation batch names the landmark
  first is bundle adjustment to the port and not to the reference.
* ``solve_auto``: each ported route end to end on a small graph gives the
  bits of the solver it names (``schur_large`` forced on a small graph,
  its gate checked on real graphs of 2,000,000 and 2,000,001
  observations); on a mesh, ``schur_cm`` solves through
  ``dist.solve_schur_cm``.
* the mesh routes: the reference's route on the reference's shape-only
  mesh cases at 3 and 8 ranks, where the two byte models agree; the pinned
  difference where they part (the port prices logical bytes, the
  reference TPU tiles); a 1-rank mesh takes the single-chip route.  The
  mesh routes run end to end on gloo ranks in ``test_torch_factor_parallel``,
  ``test_torch_schur_sharded`` and ``test_torch_schur_cm``.
* ``solve_batched``: each problem's chi2 within 1e-10 relative of the
  reference's ``solve_batched`` and of its own ``solve``, values within
  1e-10, the same iteration count, stop code and accept sequence, in
  'lm', 'gn' and 'dogleg', and with ``TDistributionLoss()`` estimating its
  scale per problem.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import to_port
from test_torch_initialize import STAGES, _stage_pair

import pyslam_tpu.solver as jsolver
from pyslam_tpu import imu as jimu
from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FACTOR_KERNELS as J_FACTOR_KERNELS
from pyslam_tpu.graph.core import FactorBatch as JFactorBatch
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.graph.core import VariableBlock as JVariableBlock
from pyslam_tpu.graph.core import register_factor as j_register_factor
from pyslam_tpu.io import bal as jbal
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu.losses import TDistributionLoss as JT
from pyslam_tpu.sensors import StereoCamera as JStereo
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu.dist import make_mesh as j_make_mesh
from pyslam_tpu_torch import dist
from pyslam_tpu_torch.graph import FactorGraph
from pyslam_tpu_torch.graph.core import FACTOR_KERNELS, register_factor
from pyslam_tpu_torch.io import synth as tsynth
from pyslam_tpu_torch.graph import build as tbuild
from pyslam_tpu_torch.losses import CauchyLoss
from pyslam_tpu_torch.solver import (
    bcsr,
    lm as tlm,
    route_auto,
    schur,
    schur_sparse,
    solve_auto,
    solve_batched,
    sparse_chol,
)
from pyslam_tpu_torch.solver.linear import HOST_READS, reset_host_reads
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64


@pytest.fixture(autouse=True, scope="module")
def _unload_compiled_programs():
    """The reference's solves here compile a program per plan; XLA:CPU
    aborts once a few hundred are loaded in one process (tests/conftest.py),
    so they are dropped when the module is done."""
    yield
    jax.clear_caches()


# --------------------------------------------------------------------------
# Shape-only stand-ins (the reference's route tests), read by both routers
# --------------------------------------------------------------------------


class _FakeBatch:
    def __init__(self, slots, n):
        self.slots = slots
        self.n = n


class _FakeBlock:
    def __init__(self, kind, n, dof, itemsize=4):
        self.kind = kind
        self.n = n
        self.dof = dof
        self.values = np.zeros((), dtype=np.float32 if itemsize == 4 else np.float64)


class _FakeGraph:
    def __init__(self, blocks, batches):
        self.blocks = blocks
        self.batches = batches

    @property
    def total_dof(self):
        return sum(b.n * b.dof for b in self.blocks.values())


def fake_pose_graph(n_poses, d=6, n_edges=None):
    blocks = {"poses": _FakeBlock("se3" if d == 6 else "se2", n_poses, d)}
    return _FakeGraph(blocks, [_FakeBatch(("poses", "poses"), n_edges or int(n_poses * 1.5))])


def fake_ba_graph(n_cams, n_pts, n_obs):
    blocks = {"poses": _FakeBlock("se3", n_cams, 6), "landmarks": _FakeBlock("euclidean", n_pts, 3)}
    return _FakeGraph(blocks, [_FakeBatch(("poses", "landmarks"), n_obs)])


FAKE = {
    "small_pose_graph": lambda: fake_pose_graph(200),
    "large_pose_graph": lambda: fake_pose_graph(50_000),
    "small_ba": lambda: fake_ba_graph(49, 7_000, 30_000),
    "many_camera_ba": lambda: fake_ba_graph(5_000, 100_000, 500_000),
    "dubrovnik_class": lambda: fake_ba_graph(300, 3_000_000, 1_500_000),
    "venice_class": lambda: fake_ba_graph(1_700, 1_000_000, 4_650_000),
    "large_2d_graph": lambda: fake_pose_graph(20_000, d=3),
    "large_3d_graph": lambda: fake_pose_graph(50_000, d=6),
}


@pytest.mark.parametrize("name", sorted(FAKE))
def test_route_of_shape_only_graphs_is_the_reference_route(name):
    g = FAKE[name]()
    assert route_auto(g) == jsolver.route_auto(g)


# --------------------------------------------------------------------------
# Real graphs
# --------------------------------------------------------------------------


def _dense_coobservation():
    """Many cameras all sharing a few landmarks: S is dense."""
    rng = np.random.default_rng(0)
    C, L, M = 1500, 40, 9000
    blocks = {
        "poses": JVariableBlock.create("se3", jnp.asarray(np.tile(np.eye(4), (C, 1, 1))), None),
        "landmarks": JVariableBlock.create("euclidean", jnp.asarray(rng.normal(size=(L, 3)))),
    }
    batch = JFactorBatch.create(
        "reprojection", ("poses", "landmarks"), (rng.integers(0, C, M), rng.integers(0, L, M)),
        {"obs": jnp.asarray(rng.normal(size=(M, 3))), "sqrt_info": jnp.eye(3),
         "camera": JStereo(cu=0.0, cv=0.0, fu=1.0, fv=1.0, b=0.1)},
        JL2(),
    )
    return JFactorGraph(blocks, [batch])


def _ba_without_observations():
    """Pose and landmark blocks, (pose, pose) factors only: no Schur shape."""
    rng = np.random.default_rng(0)
    C = 1500
    blocks = {
        "poses": JVariableBlock.create("se3", jnp.asarray(np.tile(np.eye(4), (C, 1, 1)))),
        "landmarks": JVariableBlock.create("euclidean", jnp.asarray(rng.normal(size=(5, 3)))),
    }
    batch = JFactorBatch.create(
        "between_se3", ("poses", "poses"), (np.arange(C - 1), np.arange(1, C)),
        {"T_obs": jnp.asarray(np.tile(np.eye(4), (C - 1, 1, 1))),
         "sqrt_info": jnp.asarray(np.tile(np.eye(6), (C - 1, 1, 1)))},
        JL2(),
    )
    return JFactorGraph(blocks, [batch])


def _mono(cam_cluster, dtype):
    return jbuild.bal_graph(jbal.perturbed(jbal.synthetic_bal(n_cams=6, n_pts=50, seed=0, cam_cluster=cam_cluster)),
                            dtype=dtype)


REAL = {
    # name: (builder of the reference graph, dtype of the port's copy, route_auto keywords)
    "se2_loop_40": (lambda: jbuild.pose_graph(jsynth.se2_loop(n_poses=40, n_loops=6, seed=3), dtype=F64),
                    torch.float64, {}),
    "se2_loop_60_small_dense_limit": (
        lambda: jbuild.pose_graph(jsynth.se2_loop(n_poses=60, n_loops=8, seed=1), dtype=F64), torch.float64,
        dict(dense_dof_limit=100)),
    "ba_small": (lambda: jbuild.ba_graph(jsynth.ba_synthetic(n_cams=6, n_pts=40, obs_per_pt=4, seed=8), dtype=F64),
                 torch.float64, {}),
    "ba_small_over_hpl_budget": (
        lambda: jbuild.ba_graph(jsynth.ba_synthetic(n_cams=6, n_pts=40, obs_per_pt=4, seed=8), dtype=F64),
        torch.float64, dict(dense_hpl_budget_bytes=100)),
    "stereo_clustered_f32": (
        lambda: jbuild.ba_graph(jsynth.ba_synthetic(n_cams=6, n_pts=40, obs_per_pt=4, seed=8, cam_cluster=0.05),
                                dtype=jnp.float32), torch.float32, {}),
    "mono_clustered_f32": (lambda: _mono(0.05, jnp.float32), torch.float32, {}),
    "mono_ring_f32": (lambda: _mono(None, jnp.float32), torch.float32, {}),
    "mono_clustered_f64": (lambda: _mono(0.05, F64), torch.float64, {}),
    "bal9": (lambda: jbuild.bal_graph(jbal.perturbed(jbal.synthetic_bal(n_cams=6, n_pts=60, seed=2)), dtype=F64,
                                      optimize_intrinsics=True), torch.float64, {}),
    "landmark_slam_30": (lambda: jbuild.landmark_slam_2d(jsynth.landmark_slam_2d(n_poses=30, n_landmarks=20, seed=1)),
                         torch.float32, {}),
    "landmark_slam_2000": (lambda: jbuild.landmark_slam_2d(jsynth.landmark_slam_2d(
        n_poses=2000, n_landmarks=300, max_range=10.0, odo_rot_std=0.005, seed=0)), torch.float32, {}),
    "landmark_slam_60_over_hpl_budget": (
        lambda: jbuild.landmark_slam_2d(jsynth.landmark_slam_2d(n_poses=60, n_landmarks=40, max_range=4.0, seed=3),
                                        dtype=F64), torch.float64, dict(dense_hpl_budget_bytes=1)),
    "dense_coobservation": (_dense_coobservation, torch.float64, {}),
    "ba_without_observations": (_ba_without_observations, torch.float64, {}),
}

EXPECTED = {
    "se2_loop_40": "dense", "se2_loop_60_small_dense_limit": "sparse_chol", "ba_small": "schur_dense",
    "ba_small_over_hpl_budget": "schur_pcg", "stereo_clustered_f32": "schur_dense",
    "mono_clustered_f32": "schur_sqrt", "mono_ring_f32": "schur_dense", "mono_clustered_f64": "schur_dense",
    "bal9": "schur_dense", "landmark_slam_30": "schur_dense", "landmark_slam_2000": "schur_sparse",
    "landmark_slam_60_over_hpl_budget": "schur_sparse", "dense_coobservation": "schur_pcg",
    "ba_without_observations": "dense",
}


@functools.cache
def real(name):
    make, dtype, kw = REAL[name]
    jg = make()
    return jg, to_port(jg, dtype=dtype), kw


@pytest.mark.parametrize("name", sorted(REAL))
def test_route_of_real_graphs_is_the_reference_route(name):
    jg, tg, kw = real(name)
    assert jsolver.route_auto(jg, **kw) == EXPECTED[name]
    assert route_auto(tg, **kw) == EXPECTED[name]


# --------------------------------------------------------------------------
# Switchable and visual-inertial graphs, and the chordal initialization's
# stage graphs on either side of the 12,000-dof ceiling
# --------------------------------------------------------------------------


def _switchable(make, n_out, dtype):
    poisoned, _ = jsynth.with_outliers(make(), n_out, seed=2)
    return jbuild.switchable_pose_graph(poisoned, dtype=dtype, xi=5.0)


def _vio(n):
    d = jsynth.imu_circle(n_keyframes=n, kf_dt=0.5, imu_rate=50, seed=0)
    return jimu.vio_graph(d, d.T_gt, np.diag([500.0] * 6))


SLICE9 = {
    # one lie block and one euclidean block coupled only by 3-slot factors:
    # not bundle adjustment, whatever the size
    "switchable_se2_60": (lambda: _switchable(lambda: jsynth.se2_loop(n_poses=60, n_loops=8, seed=0), 3, F64),
                          torch.float64),
    "switchable_se3_40": (lambda: _switchable(lambda: jsynth.se3_sphere(n_poses=40, n_loops=8, seed=6), 3, F64),
                          torch.float64),
    "switchable_m3500_f32": (lambda: _switchable(lambda: jsynth.se2_manhattan(n_poses=3500, seed=1), 100,
                                                 jnp.float32), torch.float32),
    "switchable_se2_5000_f32": (lambda: _switchable(lambda: jsynth.se2_manhattan(n_poses=5000, seed=1), 100,
                                                    jnp.float32), torch.float32),
    # three blocks: poses, velocities, biases
    "vio_4": (lambda: _vio(4), torch.float64),
    "vio_900": (lambda: _vio(900), torch.float64),
}


@pytest.mark.parametrize("name", sorted(SLICE9))
def test_route_of_switchable_and_vio_graphs_is_the_reference_route(name):
    make, dtype = SLICE9[name]
    jg = make()
    tg = to_port(jg, dtype=dtype)
    assert route_auto(tg) == jsolver.route_auto(jg) == "dense"


@pytest.mark.parametrize("stage,d,n", STAGES)
def test_route_of_chordal_stage_graphs_is_the_reference_route(stage, d, n):
    tg, jg = _stage_pair(stage, d, n)
    expected = "dense" if tg.total_dof <= 12000 else ("sparse_chol" if (stage, d) == ("trans", 3) else "ell")
    assert route_auto(tg) == jsolver.route_auto(jg) == expected


# --------------------------------------------------------------------------
# The is_ba repair: an observation batch that names the landmark first
# --------------------------------------------------------------------------


@register_factor("bearing_range_se2_landmark_first")
def _landmark_first_kernel(data, lm, pose, compute_jacobians=True):
    r, jacs = FACTOR_KERNELS["bearing_range_se2"](data, pose, lm, compute_jacobians=compute_jacobians)
    return r, jacs[::-1]


@j_register_factor("bearing_range_se2_landmark_first")
def _j_landmark_first_kernel(data, lm, pose, compute_jacobians=True):
    r, jacs = J_FACTOR_KERNELS["bearing_range_se2"](data, pose, lm, compute_jacobians=compute_jacobians)
    return r, jacs[::-1]


def _landmark_first(batches):
    return [dataclasses.replace(fb, kind=fb.kind + "_landmark_first", slots=fb.slots[::-1], indices=fb.indices[::-1])
            if fb.slots == ("poses", "landmarks") else fb for fb in batches]


def test_is_ba_divergence_landmark_first():
    """The reference's ``is_ba`` gate sees only (pose, landmark) batches and
    sends a graph whose observations name the landmark first to the dense
    path; the port takes either order to the Schur routes, and the solve
    reaches the dense path's optimum."""
    jg, tg, _ = real("landmark_slam_60_over_hpl_budget")
    jswap = JFactorGraph(jg.blocks, _landmark_first(jg.batches))
    tswap = FactorGraph(tg.blocks, _landmark_first(tg.batches))
    assert (jsolver.route_auto(jg), route_auto(tg)) == ("schur_dense", "schur_dense")
    assert (jsolver.route_auto(jswap), route_auto(tswap)) == ("dense", "schur_dense")
    kw = dict(dense_hpl_budget_bytes=1)
    assert (jsolver.route_auto(jswap, **kw), route_auto(tswap, **kw)) == ("dense", "schur_sparse")
    opts = tlm.Options(method="lm", max_iters=20)
    _, info = solve_auto(tswap, opts, **kw)
    _, ref = tlm.solve(tswap, opts)
    _, info_orig = solve_auto(tg, opts, **kw)
    assert torch.equal(info.chi2, info_orig.chi2)
    np.testing.assert_allclose(info.chi2.item(), ref.chi2.item(), rtol=1e-9)


# --------------------------------------------------------------------------
# solve_auto end to end
# --------------------------------------------------------------------------

ROUTES = {
    "dense": ("se2_loop_40", lambda g, o, **kw: tlm.solve(g, o)),
    "sparse_chol": ("se2_loop_60_small_dense_limit", lambda g, o, **kw: sparse_chol.solve_sparse_chol(g, o)),
    "schur_dense": ("ba_small", lambda g, o, **kw: schur.solve_schur(g, o, mode="dense")),
    "schur_pcg": ("ba_small_over_hpl_budget", lambda g, o, **kw: schur.solve_schur(g, o, mode="pcg")),
    "schur_sparse": ("landmark_slam_60_over_hpl_budget", lambda g, o, **kw: schur_sparse.solve_schur_sparse(g, o)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_solve_auto_runs_the_routed_solver(route):
    name, direct = ROUTES[route]
    _, tg, kw = real(name)
    assert route_auto(tg, **kw) == route
    opts = tlm.Options(method="lm", max_iters=20)
    reset_host_reads()
    solved, info = solve_auto(tg, opts, **kw)
    assert HOST_READS["lm"] == info.iterations
    ref_solved, ref = direct(tg, opts)
    assert info.iterations == ref.iterations and torch.equal(info.chi2, ref.chi2)
    for n, b in solved.blocks.items():
        assert torch.equal(b.values, ref_solved.blocks[n].values)
    assert info.chi2.item() < 0.5 * info.cost_history[0].item()


def test_solve_auto_ell_route():
    """An SE(3) pose graph beyond the dense limit takes ``solve_ell``."""
    g = tbuild.pose_graph(tsynth.se3_sphere(n_poses=40, seed=2), dtype=torch.float64, device="cpu")
    assert route_auto(g, dense_dof_limit=100) == "ell"
    opts = tlm.Options(method="lm", max_iters=10)
    _, info = solve_auto(g, opts, dense_dof_limit=100)
    _, ref = bcsr.solve_ell(g, opts)
    assert torch.equal(info.chi2, ref.chi2)


def _venice_class_arrays(n_obs, n_cams=10, obs_per_pt=5):
    """A stereo BA problem past or at the ``schur_large`` gate of 2,000,000
    observations, as numpy arrays: cheap to build, never solved."""
    n_pts = -(-n_obs // obs_per_pt)
    rng = np.random.default_rng(0)
    T = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    T[:, 2, 3] = 10.0
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32)
    pt_idx = np.repeat(np.arange(n_pts), obs_per_pt)[:n_obs]
    cam_idx = np.arange(n_obs) % n_cams
    obs = np.zeros((n_obs, 3), np.float32)
    blocks = {"poses": dict(kind="se3", values=T, const_mask=np.arange(n_cams) == 0),
              "landmarks": dict(kind="euclidean", values=pts, const_mask=np.zeros(n_pts, bool))}
    camera = dict(cu=320.0, cv=240.0, fu=500.0, fv=500.0, b=0.3, w=640, h=480)
    batch = dict(kind="reprojection", slots=("poses", "landmarks"), indices=[cam_idx, pt_idx],
                 data={"obs": obs, "sqrt_info": np.eye(3, dtype=np.float32)}, weight=np.ones(n_obs, np.float32),
                 camera=camera)
    return blocks, batch


@pytest.mark.parametrize("n_obs,expected", [(2_000_001, "schur_large"), (2_000_000, "schur_dense")])
def test_route_schur_large_on_a_real_graph(n_obs, expected):
    """A real graph of either package just past and just at the gate."""
    from pyslam_tpu_torch.graph import convert

    blocks, batch = _venice_class_arrays(n_obs)
    camera = batch.pop("camera")
    t_batch = dict(batch, data={**batch["data"], "camera": ("StereoCamera", camera)}, loss=("L2Loss", {}))
    tg = convert.graph_from_numpy(blocks, [t_batch], dtype=torch.float32, device="cpu")
    jb = {n: JVariableBlock(b["kind"], jnp.asarray(b["values"]), jnp.asarray(b["const_mask"]))
          for n, b in blocks.items()}
    jg = JFactorGraph(jb, [JFactorBatch.create(
        kind="reprojection", slots=batch["slots"], indices=tuple(batch["indices"]),
        data={"obs": jnp.asarray(batch["data"]["obs"]), "sqrt_info": jnp.asarray(batch["data"]["sqrt_info"]),
              "camera": JStereo(**camera)}, loss=JL2())])
    assert tg.batches[0].n == n_obs
    assert jsolver.route_auto(jg) == route_auto(tg) == expected


def test_solve_auto_runs_schur_large(monkeypatch):
    """The ``schur_large`` route runs ``solve_schur_large`` with the
    reference's arguments and returns the reference's (solved_graph,
    cost_history).  The route is forced on a small graph: the real gate
    needs more than 2,000,000 observations."""
    from pyslam_tpu.solver.schur_large import solve_schur_large as j_solve_schur_large
    from pyslam_tpu_torch import solver as tsolver
    from pyslam_tpu_torch.solver.schur_large import solve_schur_large

    jg, tg, _ = real("ba_small")
    monkeypatch.setattr(tsolver, "route_auto", lambda *a, **kw: "schur_large")
    monkeypatch.setattr(jsolver, "route_auto", lambda *a, **kw: "schur_large")
    opts = dict(method="lm", max_iters=15)
    solved, hist = solve_auto(tg, tlm.Options(**opts))
    ref_solved, ref_chi2, ref_hist = solve_schur_large(tg, tlm.Options(**opts))
    assert hist == ref_hist and ref_chi2 == hist[-1] and hist[-1] < 0.5 * hist[0]
    for n, b in solved.blocks.items():
        assert torch.equal(b.values, ref_solved.blocks[n].values)
    _, j_hist = jsolver.solve_auto(jg, jlm.Options(**opts))
    np.testing.assert_allclose(hist, j_hist, rtol=1e-9)
    _, _, j_direct = j_solve_schur_large(jg, jlm.Options(**opts))
    assert j_hist == j_direct


def test_solve_auto_runs_the_schur_sqrt_route():
    """The f32 monocular low-parallax graph routes to ``schur_sqrt`` and
    ``solve_auto`` gives the reference's solve: the same LM iterations and
    stop code, chi2 within 1e-4 relative and poses within 5e-4.  In f32
    the low-parallax system amplifies rounding: the two f32 solves sum in
    other orders and end 6.0e-5 apart in chi2 and 6.1e-5 in the poses
    (each within 1e-4 of the f64 solve, the reference's own bound)."""
    jg, tg, _ = real("mono_clustered_f32")
    assert route_auto(tg) == "schur_sqrt"
    solved, info = solve_auto(tg)
    j_solved, j_info = jsolver.solve_auto(jg)
    assert info.iterations == int(j_info.iterations) and info.status == int(j_info.status)
    np.testing.assert_allclose(info.chi2.item(), float(j_info.chi2), rtol=1e-4)
    assert info.chi2.item() < 0.02 * tg.chi2().item()
    np.testing.assert_allclose(solved.blocks["poses"].values.numpy(), np.asarray(j_solved.blocks["poses"].values),
                               rtol=0, atol=5e-4)


def test_solve_auto_refuses_what_is_not_ported(tmp_path):
    """On a mesh, the route ``schur_cm`` is the reference's, and
    ``solve_auto`` solves through it (a world of one gloo rank, the route
    given): the bits of ``dist.solve_schur_cm`` at its defaults, the accepted
    costs within 1e-9 of the reference's ``solve_auto`` on three devices.
    Nothing of the port refuses this route any more; the name is kept."""
    from torch_dist_ranks import run_group, to_arrays

    jg, tg, _ = real("ba_small")
    kw = dict(cm_obs_crossover=10)
    assert jsolver.route_auto(jg, mesh=j_make_mesh(3), **kw) == route_auto(tg, mesh=port_mesh(3), **kw) == "schur_cm"
    arrays, options = to_arrays(jg), dict(method="lm", max_iters=6)
    (out,) = run_group(1, [dict(key="auto", solver="auto", graph=arrays, options=options,
                                kw=dict(route="schur_cm", force=True, **kw)),
                           dict(key="cm", solver="cm", graph=arrays, options=options)], tmp_path, timeout_s=15)
    assert out["auto"]["history"] == out["cm"]["history"] and out["auto"]["lams"] == out["cm"]["lams"]
    for k in out["cm"]["values"]:
        np.testing.assert_array_equal(out["auto"]["values"][k], out["cm"]["values"][k])
    _, j_history = jsolver.solve_auto(jg, jlm.Options(**options), mesh=j_make_mesh(3, axis_name="l"), **kw)
    np.testing.assert_allclose(out["cm"]["history"], j_history, rtol=1e-9)
    assert out["cm"]["history"][-1] < 0.01 * out["cm"]["history"][0]


def test_problem_solve_with_mesh(tmp_path):
    """``Problem.solve(mesh=...)`` on two gloo ranks: the reference's
    ``se2_loop(12, 3, seed=4)`` problem through ``solve_auto``'s mesh route
    (``factor_parallel``), its cost within 1e-5 of the single-device solve's
    and of the JAX package's single-device ``Problem``."""
    from pyslam_tpu import SE2 as JSE2
    from pyslam_tpu import PoseToPoseResidual as JPoseToPose
    from pyslam_tpu import Problem as JProblem
    from torch_dist_ranks import pose_graph_problem, run_group

    data = tsynth.se2_loop(n_poses=12, n_loops=3, seed=4)
    arrays = {k: np.asarray(getattr(data, k)) for k in ("T_init", "edges_i", "edges_j", "T_meas", "sqrt_info")}
    options = dict(method="lm", max_iters=20)
    single = pose_graph_problem(arrays, options)
    assert route_auto(single._build(), mesh=port_mesh(2)) == "factor_parallel"
    single.solve()
    outs = run_group(2, [dict(key="problem", solver="problem", kw=arrays, options=options)], tmp_path, timeout_s=120)
    j_prob = JProblem(jlm.Options(**options))
    names = [f"T_{i}" for i in range(12)]
    for i, j, T, S in zip(data.edges_i, data.edges_j, data.T_meas, data.sqrt_info):
        j_prob.add_residual_block(JPoseToPose(T, S), [names[int(i)], names[int(j)]])
    j_prob.initialize_params({n: JSE2(jnp.asarray(T, F64)) for n, T in zip(names, data.T_init)})
    j_prob.set_parameters_constant(names[0])
    j_prob.solve()
    for out in outs:
        cost = out["problem"]["cost"]
        assert out["problem"]["collectives"]["psum"] > 0
        np.testing.assert_allclose(cost, single.eval_cost(), rtol=1e-5)
        np.testing.assert_allclose(cost, float(j_prob.eval_cost()), rtol=1e-5)
        assert cost < 0.5 * out["problem"]["summary"][0]


# --------------------------------------------------------------------------
# The mesh routes
# --------------------------------------------------------------------------


def port_mesh(n):
    """A mesh of n ranks as ``route_auto`` reads it (its size); no process
    group is needed to route."""
    return dist.Mesh(group=None, rank=0, size=n, device=torch.device("cpu"), backend="gloo")


def fake_vio_graph(n_kf):
    """The reference's 3-block VIO shape: poses, velocities, biases."""
    blocks = {"poses": _FakeBlock("se3", n_kf, 6), "vels": _FakeBlock("euclidean", n_kf, 3),
              "biases": _FakeBlock("euclidean", n_kf, 6)}
    return _FakeGraph(blocks, [_FakeBatch(("poses", "poses", "vels", "vels", "biases"), n_kf - 1),
                               _FakeBatch(("biases", "biases"), n_kf - 1), _FakeBatch(("poses",), n_kf)])


MESH_FAKE = {
    # the reference's mesh route tests (tests/test_solve_auto.py::TestRouteMesh), where both byte models agree
    "tiny_pose_graph": (lambda: fake_pose_graph(100), {}, "factor_parallel"),
    "midsize_pose_graph": (lambda: fake_pose_graph(50_000), {}, "ell"),
    "pose_graph_past_both_budgets": (lambda: fake_pose_graph(30_000_000, n_edges=120_000_000), {}, "pose_sharded"),
    "ba_block_layout": (lambda: fake_ba_graph(300, 120_000, 600_000), {}, "schur_reduce"),
    "ba_speed_crossover": (lambda: fake_ba_graph(1_700, 1_000_000, 4_650_000), {}, "schur_cm"),
    "ba_beyond_slab_budget": (lambda: fake_ba_graph(20_000, 20_000_000, 90_000_000), {}, "schur_cm"),
    "vio_midsize": (lambda: fake_vio_graph(500), {}, "factor_parallel"),
    "ba_small_budget_crossover": (lambda: fake_ba_graph(300, 120_000, 600_000), dict(cm_obs_crossover=1000),
                                  "schur_cm"),
}


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("name", sorted(MESH_FAKE))
def test_mesh_route_is_the_reference_route(name, n):
    make, kw, expected = MESH_FAKE[name]
    g = make()
    assert route_auto(g, mesh=port_mesh(n), **kw) == jsolver.route_auto(g, mesh=j_make_mesh(n), **kw) == expected


@pytest.mark.parametrize("name,kw,port,reference", [
    # 1.5 M SE(3) poses, 6 M edges: an ELL store of 3.7 GB in f32, 104 GB in TPU tiles
    ("pose_graph", {}, "ell", "pose_sharded"),
    # 75,000 observations a rank: 21.6 MB of blocks, 922 MB in TPU tiles
    ("ba", dict(device_hbm_budget_bytes=100 << 20), "schur_reduce", "schur_cm"),
])
def test_mesh_route_prices_logical_bytes(name, kw, port, reference):
    """The one pinned difference of the mesh routes: the port prices the
    sizes in the logical bytes of its tensors, the reference in (8, 128)
    f32 TPU tiles, 28 to 43 times as many for these blocks."""
    g = fake_pose_graph(1_500_000, n_edges=6_000_000) if name == "pose_graph" else fake_ba_graph(300, 120_000, 600_000)
    assert route_auto(g, mesh=port_mesh(8), **kw) == port
    assert jsolver.route_auto(g, mesh=j_make_mesh(8), **kw) == reference


def test_mesh_route_warns_for_a_multi_block_graph_beyond_the_dense_ceiling():
    g = fake_vio_graph(2_000)  # 30,000 dof
    with pytest.warns(UserWarning, match="multi-block"):
        assert jsolver.route_auto(g, mesh=j_make_mesh(8)) == "_single"
    with pytest.warns(UserWarning, match="multi-block"):
        assert route_auto(g, mesh=port_mesh(8)) == "_single"


@pytest.mark.parametrize("name", ["large_pose_graph", "small_ba", "venice_class", "small_pose_graph"])
def test_a_one_rank_mesh_takes_the_single_chip_route(name):
    g = FAKE[name]()
    assert route_auto(g, mesh=port_mesh(1)) == route_auto(g) == jsolver.route_auto(g, mesh=j_make_mesh(1))


def test_bal9_on_a_mesh_never_routes_schur_cm():
    """``schur_cm`` is specialized to 6-dof cameras: a 9-dof graph stays on
    ``schur_reduce`` past every budget."""
    jg, tg, _ = real("bal9")
    kw = dict(device_hbm_budget_bytes=1, cm_obs_crossover=1)
    assert route_auto(tg, mesh=port_mesh(8), **kw) == jsolver.route_auto(jg, mesh=j_make_mesh(8), **kw)
    assert route_auto(tg, mesh=port_mesh(8), **kw) == "schur_reduce"


# --------------------------------------------------------------------------
# solve_batched
# --------------------------------------------------------------------------


@functools.cache
def fleet(n_poses=20, n_loops=3, count=5):
    jgs = [jbuild.pose_graph(jsynth.se2_loop(n_poses=n_poses, n_loops=n_loops, seed=s), dtype=F64)
           for s in range(count)]
    return jgs, [to_port(g) for g in jgs]


def _check_against_single_solves(tgs, values, chi2, info, opts):
    for i, g in enumerate(tgs):
        s, ref = tlm.solve(g, opts)
        assert info.iterations[i] == ref.iterations and info.status[i] == ref.status
        np.testing.assert_array_equal(info.accepted[i].numpy(), ref.accepted.numpy())
        np.testing.assert_allclose(chi2[i].item(), ref.chi2.item(), rtol=1e-10)
        np.testing.assert_allclose(info.cost_history[i].numpy(), ref.cost_history.numpy(), rtol=1e-10)
        np.testing.assert_allclose(info.lambda_history[i].numpy(), ref.lambda_history.numpy(), rtol=1e-12)
        np.testing.assert_allclose(values["poses"][i].numpy(), s.blocks["poses"].values.numpy(), rtol=0, atol=1e-10)


def test_solve_batched_matches_reference_and_single_solves():
    jgs, tgs = fleet()
    opts = dict(method="lm", max_iters=25)
    jvalues, jchi2 = jsolver.solve_batched(jgs, jlm.Options(**opts))
    reset_host_reads()
    values, chi2, info = solve_batched(tgs, tlm.Options(**opts), return_info=True)
    assert HOST_READS["lm"] == max(info.iterations)  # one read of the fleet an iteration
    assert values["poses"].shape == (5, 20, 3, 3) and chi2.shape == (5,)
    np.testing.assert_allclose(chi2.numpy(), np.asarray(jchi2), rtol=1e-10)
    np.testing.assert_allclose(values["poses"].numpy(), np.asarray(jvalues["poses"]), rtol=0, atol=1e-10)
    _check_against_single_solves(tgs, values, chi2, info, tlm.Options(**opts))


OPTIONS = {
    "gn": dict(method="gn", max_iters=20),
    "lm_not_speculative": dict(method="lm", max_iters=20, speculative=False),
    # a start far from the optimum and a tiny first lambda: rejected steps
    "lm_rejections": dict(method="lm", max_iters=30, lambda_init=1e-9, min_cost_decrease=0.999999),
    "lm_one_iteration": dict(method="lm", max_iters=1),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_solve_batched_follows_each_single_solve(name):
    """Problems of a fleet that stop at different iterations, with
    rejections, in every supported mode: each follows its own ``solve``."""
    datas = [tsynth.se2_loop(n_poses=30, n_loops=4, odo_rot_std=0.05 * (1 + s), seed=s) for s in range(4)]
    tgs = [tbuild.pose_graph(d, loss=CauchyLoss(1.0), dtype=torch.float64, device="cpu") for d in datas]
    opts = tlm.Options(**OPTIONS[name])
    values, chi2, info = solve_batched(tgs, opts, return_info=True)
    _check_against_single_solves(tgs, values, chi2, info, opts)
    if name == "lm_rejections":
        assert not info.accepted.all() and len(set(info.iterations)) > 1


def test_solve_batched_takes_a_stacked_graph_and_refuses_mixed_structure():
    _, tgs = fleet()
    opts = tlm.Options(method="lm", max_iters=25)
    v_list, c_list = solve_batched(tgs, opts)
    g0 = tgs[0]

    def stack(get):
        return torch.stack([get(g) for g in tgs])

    stacked = FactorGraph(
        {n: dataclasses.replace(b, values=stack(lambda g: g.blocks[n].values),
                                const_mask=stack(lambda g: g.blocks[n].const_mask))
         for n, b in g0.blocks.items()},
        [dataclasses.replace(fb, indices=tuple(stack(lambda g: g.batches[k].indices[s]) for s in range(len(fb.slots))),
                             data={key: stack(lambda g: g.batches[k].data[key]) for key in fb.data},
                             weight=stack(lambda g: g.batches[k].weight))
         for k, fb in enumerate(g0.batches)],
    )
    v_stacked, c_stacked = solve_batched(stacked, opts)
    assert torch.equal(c_list, c_stacked) and torch.equal(v_list["poses"], v_stacked["poses"])
    other = tbuild.pose_graph(tsynth.se2_loop(n_poses=21, n_loops=3, seed=0), dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="differ"):
        solve_batched([tgs[0], other], opts)
    jgs, _ = fleet()
    dogleg = dict(method="dogleg", max_iters=25)
    jvalues, jchi2 = jsolver.solve_batched(jgs, jlm.Options(**dogleg))
    values, chi2, info = solve_batched(tgs, tlm.Options(**dogleg), return_info=True)
    np.testing.assert_allclose(chi2.numpy(), np.asarray(jchi2), rtol=1e-10)
    np.testing.assert_allclose(values["poses"].numpy(), np.asarray(jvalues["poses"]), rtol=0, atol=1e-10)
    _check_against_single_solves(tgs, values, chi2, info, tlm.Options(**dogleg))


@pytest.mark.parametrize("method", ["lm", "dogleg"])
def test_solve_batched_estimates_the_t_scale_per_problem(method):
    """``TDistributionLoss()`` (scale None) re-estimates its scale from the
    residuals: each problem from its own, as the reference's vmap of
    ``solve`` does, never one scale over the fleet.  Problems with noise of
    different sizes, against the reference's ``solve_batched`` and each
    problem's own ``solve``."""
    jgs = [jbuild.pose_graph(jsynth.se2_loop(n_poses=20, n_loops=3, odo_rot_std=0.01 * (1 + 2 * s), seed=s),
                             loss=JT(), dtype=F64) for s in range(4)]
    tgs = [to_port(g) for g in jgs]
    opts = dict(method=method, max_iters=25)
    jvalues, jchi2 = jsolver.solve_batched(jgs, jlm.Options(**opts))
    values, chi2, info = solve_batched(tgs, tlm.Options(**opts), return_info=True)
    np.testing.assert_allclose(chi2.numpy(), np.asarray(jchi2), rtol=1e-10)
    np.testing.assert_allclose(values["poses"].numpy(), np.asarray(jvalues["poses"]), rtol=0, atol=1e-10)
    _check_against_single_solves(tgs, values, chi2, info, tlm.Options(**opts))
