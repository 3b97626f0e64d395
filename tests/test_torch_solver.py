"""The twin of ``tests/test_solver.py``: its cases through the port, against
the JAX package on the same numpy inputs, in f64 on the CPU, at the
reference test's tolerances.

Held here:
  * ``TestQuadraticFit::test_converges_to_truth``;
  * ``TestPoseGraph2D::test_padding_inert`` and
    ``::test_factor_order_invariance`` on every route ``solve_auto`` takes
    for a pose graph: ``dense`` (``lm.solve``), ``sparse_chol``
    (``solve_sparse_chol``) and ``ell`` (``bcsr.solve_ell``, SE(2) on the
    general assembly, SE(3) on ``ell_assemble``'s plain version), padded
    with zero-weight self-loops on (0, 0) as the reference pads, and on a
    free pose; each route's unpadded chi2 beside the JAX package's;
  * ``TestPoseGraph2D::test_scipy_parity``, ``::test_robust_loss_rejects_outliers``,
    ``::test_constant_params_respected``;
  * ``TestPoseGraph3D::test_se3_sphere_converges``, ``::test_perturbation_recovery``;
  * ``TestBundleAdjustment::test_small_ba_converges``;
  * ``TestSolveAuto::test_venice_scale_with_priors_routes_to_schur_large``,
    ``::test_small_ba_with_priors_routes_to_schur``: the routes of the
    reference's shape-only BA graphs with a prior batch;
  * ``TestSolveBatched::test_monte_carlo_covariance_consistency``;
  * ``TestDogleg::test_matches_lm_se3``, ``::test_accepted_costs_monotone``.

Held by other port files:
  * ``TestPoseGraph2D::test_gn_converges``, ``::test_lm_converges``:
    ``test_torch_dense.py::test_dense_solve_matches_reference`` (LM and GN on
    ``se2_loop``: the reference's iterations, accept sequence and cost
    history, so its monotone accepted costs);
  * ``TestPoseGraph2D::test_solve_one_iter_decreases_cost``:
    ``test_torch_dense.py::test_solve_one_iter_matches_reference``;
  * ``TestSolveAuto::test_pose_graph_small_dense``, ``::test_ba_routes_to_schur``:
    ``test_torch_solve_auto.py::test_solve_auto_runs_the_routed_solver``
    (``dense`` and ``schur_dense``);
  * ``TestSolveAuto::test_dense_mode_gated_on_hpl_memory``:
    ``test_torch_solve_auto.py::test_route_of_real_graphs_is_the_reference_route``
    (``ba_small`` and ``ba_small_over_hpl_budget``);
  * ``TestSolveAuto::test_problem_api_uses_dispatch``:
    ``test_torch_problem.py::test_built_graph_is_the_builders_graph``;
  * ``TestSolveBatched::test_fleet_matches_individual``:
    ``test_torch_solve_auto.py::test_solve_batched_matches_reference_and_single_solves``;
  * ``TestSpanningTreeInit::test_reproduces_odometry_integration``,
    ``::test_solves_from_tree_init``, ``::test_disconnected_gets_root_pose``,
    ``::test_reverse_edges``: ``test_torch_initialize.py::test_spanning_tree_init_is_the_reference``
    (the reference's arrays bit for bit on two graphs), and the reference's
    own four cases here, in ``test_spanning_tree_init_edge_cases``;
  * ``TestDogleg::test_matches_lm_se2``, ``::test_tiny_trust_radius_still_converges``:
    ``test_torch_dense.py::test_dense_solve_matches_reference`` (dogleg on
    ``se2_loop``, ``trust_radius_init`` 1e-4 among them);
  * ``TestDogleg::test_custom_path_requires_matvec``:
    ``test_torch_dense.py::test_dogleg_with_custom_path_needs_matvec``;
  * ``TestDogleg::test_dogleg_on_ell_path``:
    ``test_torch_solve.py::test_solve_ell_dogleg_matches_reference``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy_ref
import torch

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorBatch as JFactorBatch
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.graph.core import VariableBlock as JVariableBlock
from pyslam_tpu.graph.initialize import spanning_tree_init as j_spanning_tree_init
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.losses import CauchyLoss as JCauchy
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu import solver as jsolver
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu_torch.graph import FactorBatch, FactorGraph, VariableBlock, build
from pyslam_tpu_torch.graph.initialize import spanning_tree_init
from pyslam_tpu_torch.io import synth
from pyslam_tpu_torch.lie import se2, se3
from pyslam_tpu_torch.losses import CauchyLoss, L2Loss
from pyslam_tpu_torch.solver import Options, bcsr, route_auto, solve, solve_batched, sparse_chol
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _unload_compiled_programs():
    """The reference's solves compile a program a graph; they are dropped
    when the module is done (tests/conftest.py)."""
    yield
    jax.clear_caches()


def small_se2(seed=1):
    return synth.se2_loop(n_poses=40, n_loops=6, seed=seed)


def _max_pose_err(T_gt, T, ops):
    return ops.log(torch.as_tensor(T_gt) @ ops.inv(T)).abs().max().item()


# --------------------------------------------------------------------------
# The quadratic fit
# --------------------------------------------------------------------------


def test_quadratic_fit_converges_to_truth():
    rng = np.random.default_rng(0)
    truth = np.array([2.0, -1.0, 0.5])
    x = rng.uniform(-3, 3, 80)
    y = truth[0] * x * x + truth[1] * x + truth[2] + rng.normal(0, 0.01, 80)
    idx = np.zeros(80, np.int64)
    data = {"x": x, "y": y, "stiffness": np.full(80, 1.0 / 0.01)}
    tg = FactorGraph({"params": VariableBlock.create("euclidean", torch.zeros((1, 3), dtype=F64))},
                     [FactorBatch.create("quadratic", ("params",), (idx,),
                                         {k: torch.tensor(v) for k, v in data.items()}, L2Loss())])
    jg = JFactorGraph({"params": JVariableBlock.create("euclidean", jnp.zeros((1, 3), jnp.float64))},
                      [JFactorBatch.create("quadratic", ("params",), (idx.astype(np.int32),),
                                           {k: jnp.asarray(v) for k, v in data.items()}, JL2())])
    opts = dict(method="gn", max_iters=20)
    solved, info = solve(tg, Options(**opts))
    j_solved, j_info = jlm.solve(jg, jlm.Options(**opts))
    est = solved.blocks["params"].values[0].numpy()
    np.testing.assert_allclose(est, truth, atol=0.01)
    np.testing.assert_allclose(est, np.asarray(j_solved.blocks["params"].values[0]), rtol=1e-10)
    assert info.iterations == int(j_info.iterations) <= 3  # linear: GN converges in one step


# --------------------------------------------------------------------------
# Padding and factor order, on every pose-graph route
# --------------------------------------------------------------------------

ROUTES = {
    "dense": lambda g, o: solve(g, o),
    "sparse_chol": lambda g, o: sparse_chol.solve_sparse_chol(g, o),
    "ell": lambda g, o: bcsr.solve_ell(g, o),
}
GRAPHS = {"se2": lambda: small_se2(), "se3": lambda: synth.se3_sphere(n_poses=40, n_loops=10, seed=2)}
CASES = [("dense", "se2"), ("sparse_chol", "se2"), ("ell", "se2"), ("ell", "se3")]
OPTS = dict(method="lm", max_iters=25)


def _padded(g, at):
    """The reference's padding: the batch's first measurements again, with
    weight 0, on the poses (i, i) of ``at``."""
    (fb,) = g.batches
    pad = torch.tensor(at, dtype=fb.indices[0].dtype)
    return FactorGraph(g.blocks, [dataclasses.replace(
        fb, indices=tuple(torch.cat([i, pad]) for i in fb.indices),
        data={k: torch.cat([v, v[: len(at)]]) for k, v in fb.data.items()},
        weight=torch.cat([fb.weight, fb.weight.new_zeros(len(at))]))])


@pytest.fixture(scope="module")
def reference_chi2():
    """The JAX package's dense LM chi2 of each graph, and of each route's
    own solver where it is cheap on the CPU (``solve_ell``)."""
    from pyslam_tpu.solver.bcsr import solve_ell as j_solve_ell

    out = {}
    for name, make in GRAPHS.items():
        jg = jbuild.pose_graph(make(), dtype=jnp.float64)
        out["dense", name] = float(jlm.solve(jg, jlm.Options(**OPTS))[1].chi2)
        out["ell", name] = float(j_solve_ell(jg, jlm.Options(**OPTS))[1].chi2)
    return out


@pytest.fixture(scope="module")
def route_solves():
    """Each route's solve of each graph, unpadded."""
    return {(r, n): ROUTES[r](build.pose_graph(GRAPHS[n](), dtype=F64, device="cpu"), Options(**OPTS))
            for r, n in CASES}


@pytest.mark.parametrize("route,graph", CASES)
@pytest.mark.parametrize("at", [(0,) * 7, (0, 3, 3, 17, 0, 39, 0)], ids=["anchor", "free_poses"])
def test_padding_inert(route, graph, at, route_solves, reference_chi2):
    """Zero-weight (padding) factors do not change the solution."""
    s1, i1 = route_solves[route, graph]
    s2, i2 = ROUTES[route](_padded(build.pose_graph(GRAPHS[graph](), dtype=F64, device="cpu"), at), Options(**OPTS))
    np.testing.assert_allclose(i2.chi2.item(), i1.chi2.item(), rtol=1e-12)
    np.testing.assert_allclose(s2.blocks["poses"].values.numpy(), s1.blocks["poses"].values.numpy(), rtol=0,
                               atol=1e-12)
    ref = reference_chi2.get((route, graph), reference_chi2["dense", graph])
    np.testing.assert_allclose(i1.chi2.item(), ref, rtol=1e-8)


@pytest.mark.parametrize("route,graph", CASES)
def test_factor_order_invariance(route, graph, route_solves):
    data = GRAPHS[graph]()
    perm = np.random.default_rng(0).permutation(len(data.edges_i))
    shuffled = dataclasses.replace(data, edges_i=data.edges_i[perm], edges_j=data.edges_j[perm],
                                   T_meas=data.T_meas[perm], sqrt_info=data.sqrt_info[perm])
    _, i1 = route_solves[route, graph]
    _, i2 = ROUTES[route](build.pose_graph(shuffled, dtype=F64, device="cpu"), Options(**OPTS))
    np.testing.assert_allclose(i2.chi2.item(), i1.chi2.item(), rtol=1e-8)


# --------------------------------------------------------------------------
# Convergence and parity
# --------------------------------------------------------------------------


def _both(make_data, opts, builder="pose_graph"):
    """The port's and the JAX package's solve of one problem."""
    g = getattr(build, builder)(make_data(synth), dtype=F64, device="cpu")
    jg = getattr(jbuild, builder)(make_data(jsynth), dtype=jnp.float64)
    return g, solve(g, Options(**opts)), jlm.solve(jg, jlm.Options(**opts))


def test_scipy_parity():
    """Converged chi2 matches the independent scipy GN solver."""
    data = synth.se2_loop(n_poses=25, n_loops=4, seed=3)
    g = build.pose_graph(data, dtype=F64, device="cpu")
    opts = dict(method="lm", max_iters=60, min_cost_decrease=0.999999)
    _, info = solve(g, Options(**opts))
    _, j_info = jlm.solve(jbuild.pose_graph(jsynth.se2_loop(n_poses=25, n_loops=4, seed=3), dtype=jnp.float64),
                          jlm.Options(**opts))
    _, chi2_ref, _ = scipy_ref.solve_pose_graph(data, max_iters=60)
    assert abs(info.chi2.item() - chi2_ref) / chi2_ref < 1e-5
    np.testing.assert_allclose(info.chi2.item(), float(j_info.chi2), rtol=1e-10)


def test_robust_loss_rejects_outliers():
    data = small_se2(seed=7)
    bad = data.T_meas.copy()
    bad[-1] = synth._se2_mat(5.0, -3.0, 1.5) @ bad[-1]
    bad[-2] = synth._se2_mat(-4.0, 2.0, -2.0) @ bad[-2]
    data_bad = dataclasses.replace(data, T_meas=bad)
    opts = dict(method="lm", max_iters=50)
    errs = {}
    for name, loss, jloss in (("l2", L2Loss(), JL2()), ("cauchy", CauchyLoss(1.0), JCauchy(1.0))):
        s, _ = solve(build.pose_graph(data_bad, loss=loss, dtype=F64, device="cpu"), Options(**opts))
        js, _ = jlm.solve(jbuild.pose_graph(data_bad, loss=jloss, dtype=jnp.float64), jlm.Options(**opts))
        np.testing.assert_allclose(s.blocks["poses"].values.numpy(), np.asarray(js.blocks["poses"].values), rtol=0,
                                   atol=1e-6)
        errs[name] = _max_pose_err(data.T_gt, s.blocks["poses"].values, se2)
    assert errs["cauchy"] < errs["l2"] * 0.7  # robust loss materially better


def test_constant_params_respected():
    data = small_se2()
    g = build.pose_graph(data, dtype=F64, device="cpu")
    const = np.zeros(data.T_gt.shape[0], bool)
    const[0] = const[5] = True
    b = g.blocks["poses"]
    g = FactorGraph({"poses": dataclasses.replace(b, const_mask=torch.from_numpy(const))}, g.batches)
    jg = jbuild.pose_graph(data, dtype=jnp.float64)
    jb = jg.blocks["poses"]
    jg = JFactorGraph({"poses": JVariableBlock(jb.kind, jb.values, jnp.asarray(const))}, jg.batches)
    opts = dict(method="lm", max_iters=20)
    s, _ = solve(g, Options(**opts))
    js, _ = jlm.solve(jg, jlm.Options(**opts))
    np.testing.assert_allclose(s.blocks["poses"].values[5].numpy(), b.values[5].numpy(), atol=1e-12)
    np.testing.assert_allclose(s.blocks["poses"].values.numpy(), np.asarray(js.blocks["poses"].values), rtol=0,
                               atol=1e-6)


def test_se3_sphere_converges():
    g, (s, info), (js, j_info) = _both(lambda m: m.se3_sphere(n_poses=80, seed=2), dict(method="lm", max_iters=40))
    assert info.chi2.item() < g.chi2().item() * 0.1
    np.testing.assert_allclose(info.chi2.item(), float(j_info.chi2), rtol=1e-8)
    assert _max_pose_err(synth.se3_sphere(n_poses=80, seed=2).T_gt, s.blocks["poses"].values, se3) < 0.5


def test_perturbation_recovery():
    """Perturb the odometry init, solve with exact measurements, recover
    the ground truth (gauge-fixed)."""
    data = synth.se3_sphere(n_poses=40, odo_trans_std=1e-8, odo_rot_std=1e-8, seed=5)
    g = build.pose_graph(data, dtype=F64, device="cpu", init="odometry")
    noise = np.random.default_rng(0).normal(0, 0.05, (40, 6))
    noise[0] = 0.0
    vals = se3.exp(torch.from_numpy(noise)) @ g.blocks["poses"].values
    g = FactorGraph({"poses": dataclasses.replace(g.blocks["poses"], values=vals)}, g.batches)
    jg = jbuild.pose_graph(jsynth.se3_sphere(n_poses=40, odo_trans_std=1e-8, odo_rot_std=1e-8, seed=5),
                           dtype=jnp.float64, init="odometry")
    jg = JFactorGraph({"poses": dataclasses.replace(jg.blocks["poses"], values=jnp.asarray(vals.numpy()))},
                      jg.batches)
    opts = dict(method="lm", max_iters=60)
    s, _ = solve(g, Options(**opts))
    js, _ = jlm.solve(jg, jlm.Options(**opts))
    assert _max_pose_err(data.T_gt, s.blocks["poses"].values, se3) < 1e-3
    np.testing.assert_allclose(s.blocks["poses"].values.numpy(), np.asarray(js.blocks["poses"].values), rtol=0,
                               atol=1e-6)


def test_small_ba_converges():
    data = synth.ba_synthetic(n_cams=6, n_pts=60, obs_per_pt=3, seed=4)
    g, (s, info), (js, j_info) = _both(lambda m: m.ba_synthetic(n_cams=6, n_pts=60, obs_per_pt=3, seed=4),
                                       dict(method="lm", max_iters=40), builder="ba_graph")
    assert info.chi2.item() < g.chi2().item() * 0.05
    np.testing.assert_allclose(info.chi2.item(), float(j_info.chi2), rtol=1e-8)
    assert np.median(np.abs(s.blocks["landmarks"].values.numpy() - data.pts_gt)) < 0.05


# --------------------------------------------------------------------------
# Routes of BA graphs with priors, the fleet, dogleg, the spanning tree
# --------------------------------------------------------------------------


def _fake_ba_graphs(n_obs, with_prior):
    """The reference's structure-only BA graph (never evaluated), in both
    packages."""
    z = np.zeros(n_obs, np.int64)
    jblocks = dict(poses=JVariableBlock.create("se3", np.tile(np.eye(4), (3, 1, 1))),
                   landmarks=JVariableBlock.create("euclidean", np.zeros((5, 3))))
    tblocks = dict(poses=VariableBlock.create("se3", torch.eye(4, dtype=F64).repeat(3, 1, 1)),
                   landmarks=VariableBlock.create("euclidean", torch.zeros((5, 3), dtype=F64)))
    jb = [JFactorBatch.create("reprojection_bal", ("poses", "landmarks"), (z.astype(np.int32),) * 2, {}, None)]
    tb = [FactorBatch("reprojection_bal", ("poses", "landmarks"), (torch.from_numpy(z),) * 2, {}, None,
                      torch.ones(n_obs, dtype=F64))]
    if with_prior:
        z2 = np.zeros(2, np.int64)
        jb.append(JFactorBatch.create("prior_se3", ("poses",), (z2.astype(np.int32),), {}, None))
        tb.append(FactorBatch("prior_se3", ("poses",), (torch.from_numpy(z2),), {}, None, torch.ones(2, dtype=F64)))
    return JFactorGraph(jblocks, jb), FactorGraph(tblocks, tb)


@pytest.mark.parametrize("n_obs,with_prior,expected", [
    (2_000_001, True, "schur_large"), (100, True, "schur_dense"), (100, False, "schur_dense")])
def test_ba_with_priors_routes(n_obs, with_prior, expected):
    """A Venice-scale BA graph with a pose-prior batch takes ``schur_large``
    (the reference's round-1 routing repair); a small one takes the dense
    Schur mode, and over the H_pl budget the PCG mode."""
    jg, tg = _fake_ba_graphs(n_obs, with_prior)
    assert route_auto(tg) == jsolver.route_auto(jg) == expected
    if n_obs == 100:
        assert route_auto(tg, dense_hpl_budget_bytes=100) == jsolver.route_auto(jg, dense_hpl_budget_bytes=100) \
            == "schur_pcg"


def test_monte_carlo_covariance_consistency():
    """A fleet of resampled-noise problems: the spread of the solutions is
    finite and nonzero, and each problem's chi2 is the reference's."""
    opts = dict(method="lm", max_iters=25)
    graphs = [build.pose_graph(synth.se2_loop(n_poses=15, n_loops=2, seed=s), dtype=F64, device="cpu")
              for s in range(8)]
    values, chi2s = solve_batched(graphs, Options(**opts))
    j_values, j_chi2s = jsolver.solve_batched(
        [jbuild.pose_graph(jsynth.se2_loop(n_poses=15, n_loops=2, seed=s), dtype=jnp.float64) for s in range(8)],
        jlm.Options(**opts))
    spread = values["poses"].numpy()[:, -1, :2, 2].std(axis=0)
    assert np.isfinite(spread).all() and (spread > 0).all()
    np.testing.assert_allclose(chi2s.numpy(), np.asarray(j_chi2s), rtol=1e-10)


def test_dogleg_matches_lm_se3_with_monotone_costs():
    opts = dict(max_iters=40)
    _, (_, i_lm), _ = _both(lambda m: m.se3_sphere(n_poses=80, n_loops=20, seed=2), dict(method="lm", **opts))
    _, (_, i_dl), (_, j_dl) = _both(lambda m: m.se3_sphere(n_poses=80, n_loops=20, seed=2),
                                    dict(method="dogleg", **opts))
    np.testing.assert_allclose(i_dl.chi2.item(), i_lm.chi2.item(), rtol=1e-6)
    np.testing.assert_allclose(i_dl.chi2.item(), float(j_dl.chi2), rtol=1e-8)
    hist = i_dl.cost_history.numpy()
    hist = hist[~np.isnan(hist)]
    assert np.all(np.diff(hist) <= 1e-9)


def test_spanning_tree_init_edge_cases():
    """The chain (the tree is the odometry), poses no edge reaches (the
    root pose) and every edge reversed, each the reference's arrays."""
    chain = synth.se2_loop(n_poses=25, n_loops=0, seed=0)
    T0 = spanning_tree_init(chain.edges_i, chain.edges_j, chain.T_meas, 25, T_root=chain.T_gt[0])
    np.testing.assert_allclose(T0, chain.T_init, atol=1e-9)
    np.testing.assert_array_equal(
        T0, j_spanning_tree_init(chain.edges_i, chain.edges_j, chain.T_meas, 25, T_root=chain.T_gt[0]))
    T_meas = np.tile(np.eye(3), (1, 1, 1))
    T0 = spanning_tree_init([0], [1], T_meas, 4)
    np.testing.assert_allclose(T0[2:], np.broadcast_to(np.eye(3), (2, 3, 3)))
    np.testing.assert_array_equal(T0, j_spanning_tree_init([0], [1], T_meas, 4))
    data = synth.se2_loop(n_poses=10, n_loops=0, seed=1)
    args = (data.edges_j, data.edges_i, np.linalg.inv(data.T_meas), 10)
    T0 = spanning_tree_init(*args, T_root=data.T_gt[0])
    np.testing.assert_allclose(T0, data.T_init, atol=1e-9)
    np.testing.assert_array_equal(T0, j_spanning_tree_init(*args, T_root=data.T_gt[0]))
    # and the solve from the tree init of a sphere
    sphere = synth.se3_sphere(n_poses=40, n_loops=10, seed=5)
    sphere.T_init = spanning_tree_init(sphere.edges_i, sphere.edges_j, sphere.T_meas, 40, T_root=sphere.T_gt[0])
    g = build.pose_graph(sphere, dtype=F64, device="cpu")
    _, info = solve(g, Options(method="lm", max_iters=30))
    assert info.chi2.item() < g.chi2().item() * 0.5
