"""The twin of ``tests/test_sim3.py``: its Sim(3) cases through the port, on
the reference's own inputs, against the JAX package in f64 on the CPU, at
the reference test's tolerances.

Held here: ``TestSim3Group::test_left_jacobian_vs_autodiff``,
``::test_inv_left_jacobian``, ``::test_inv_left_jacobian_vs_autodiff``,
``::test_wrapper_class`` (against ``torch.func.jacfwd`` of the port's own
exp and log, and the reference's values); ``TestSim3Kernels::test_zero_at_consistent``,
``::test_object_api``; ``TestSim3Problem::test_problem_api_end_to_end``;
``TestSim3PoseGraph::test_recovers_consistent_graph``,
``::test_scale_drift_correction``, ``::test_ell_path_matches_dense``,
``::test_route_auto_large_sim3``, ``::test_gauge_anchoring``;
``TestSim3ScipyParity::test_chi2_matches_independent_scipy_solver``;
``TestSim3Covariance::test_marginals_vs_dense_inverse``;
``::test_sim3_landmark_graph_through_schur_routing``.

Held by other port files (each group function within 1e-12 of the
reference's, 1e-9 near pi and at small log-scales, in every branch of
``_W_coeffs``):
  * ``TestSim3Group::test_exp_log_roundtrip``, ``::test_exp_log_small``,
    ``::test_exp_log_branch_boundaries``: ``test_torch_lie2.py::test_sim3_exp_log_roundtrip``
    and ``test_torch_lie2.py::test_sim3_matches_reference`` (exp, log);
  * ``TestSim3Group::test_scale_extraction``, ``::test_inv``,
    ``::test_adjoint_identity``, ``::test_wedge_vee``, ``::test_act``,
    ``::test_normalize``: ``test_torch_lie2.py::test_sim3_matches_reference``
    (scale, rot, inv, adjoint, wedge, vee, act, normalize);
  * ``TestSim3Group::test_se3_embed``: ``test_torch_lie2.py::test_sim3_from_se3``;
  * ``TestSim3Kernels::test_prior_jacobian_vs_autodiff``,
    ``::test_between_jacobians_vs_autodiff``:
    ``test_torch_dense.py::test_factor_kernels_match_reference``
    (``prior_sim3``, ``between_sim3``: residuals and Jacobians within 1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy_ref
import torch

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.lie import Sim3 as JSim3
from pyslam_tpu.lie import sim3 as jsim3
from pyslam_tpu import solver as jsolver
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu_torch import PoseResidual, PoseToPoseResidual, Problem
from pyslam_tpu_torch.graph import FACTOR_KERNELS, FactorBatch, FactorGraph, VariableBlock, build
from pyslam_tpu_torch.graph import register_autodiff_factor
from pyslam_tpu_torch.io import synth
from pyslam_tpu_torch.lie import Sim3, sim3
from pyslam_tpu_torch.losses import L2Loss
from pyslam_tpu_torch.solver import Options, bcsr, full_covariance, marginal_covariances, route_auto, solve
from pyslam_tpu_torch.solver import solve_auto
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _unload_compiled_programs():
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_xi(rng, scale=0.8, batch=()):
    """Random Sim(3) tangents with |phi| inside the injectivity radius."""
    xi = rng.normal(size=batch + (7,)) * scale
    phi = xi[..., 3:6]
    n = np.linalg.norm(phi, axis=-1, keepdims=True)
    xi[..., 3:6] = phi / np.maximum(n, 1e-12) * np.minimum(n, np.pi - 0.05)
    return xi


def test_left_jacobians(rng):
    """J_l against the forward-mode derivative of log(exp(xi + d) exp(xi)^-1),
    J_l^-1 against that of log(exp(eps) S), J_l J_l^-1 = I, each the
    reference's."""
    xi = torch.from_numpy(random_xi(rng, 0.9))
    J_auto = torch.func.jacfwd(lambda d: sim3.log(sim3.exp(xi + d) @ sim3.inv(sim3.exp(xi))))(torch.zeros(7, dtype=F64))
    np.testing.assert_allclose(sim3.left_jacobian(xi).numpy(), J_auto.numpy(), atol=1e-9)
    S = sim3.exp(xi)
    Ji_auto = torch.func.jacfwd(lambda e: sim3.log(sim3.exp(e) @ S))(torch.zeros(7, dtype=F64))
    np.testing.assert_allclose(sim3.inv_left_jacobian(xi).numpy(), Ji_auto.numpy(), atol=1e-9)
    xs = torch.from_numpy(random_xi(rng, 1.2, (16,)))
    J, Jinv = sim3.left_jacobian(xs), sim3.inv_left_jacobian(xs)
    np.testing.assert_allclose((J @ Jinv).numpy(), np.broadcast_to(np.eye(7), J.shape), atol=1e-10)
    np.testing.assert_allclose(Jinv.numpy(), np.asarray(jsim3.inv_left_jacobian(jnp.asarray(xs.numpy()))), atol=1e-12)


def test_wrapper_class(rng):
    xi = random_xi(rng, 0.8)
    S, JS = Sim3.exp(torch.from_numpy(xi)), JSim3.exp(jnp.asarray(xi))
    np.testing.assert_allclose(S.log().numpy(), xi, atol=1e-9)
    np.testing.assert_allclose(float(S.scale), float(np.exp(xi[6])), atol=1e-12)
    np.testing.assert_allclose(S.dot(S.inv()).mat.numpy(), np.eye(4), atol=1e-12)
    np.testing.assert_allclose(S.mat.numpy(), np.asarray(JS.mat), atol=1e-12)


def test_zero_at_consistent(rng):
    S1 = sim3.exp(torch.from_numpy(random_xi(rng, 0.8, (4,))))
    S2 = sim3.exp(torch.from_numpy(random_xi(rng, 0.8, (4,))))
    data = {"T_obs": S2 @ sim3.inv(S1), "sqrt_info": torch.eye(7, dtype=F64).expand(4, 7, 7)}
    r, _ = FACTOR_KERNELS["between_sim3"](data, S1, S2, False)
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-9)


def test_object_api(rng):
    """``PoseResidual`` / ``PoseToPoseResidual`` dispatch on the ``Sim3``
    wrapper."""
    S_obs = Sim3.exp(torch.from_numpy(random_xi(rng, 0.7)))
    res = PoseResidual(S_obs, 2.0)
    assert res.factor_kind == "prior_sim3"
    np.testing.assert_allclose(np.asarray(res.evaluate([S_obs])), 0.0, atol=1e-9)
    res2 = PoseToPoseResidual(S_obs, 1.0)
    assert res2.factor_kind == "between_sim3"
    S1 = Sim3.exp(torch.from_numpy(random_xi(rng, 0.7)))
    np.testing.assert_allclose(np.asarray(res2.evaluate([S1, Sim3(S_obs.mat @ S1.mat)])), 0.0, atol=1e-8)


def test_problem_api_end_to_end(rng):
    """Sim3 parameters go through the sim3 manifold (the reference once fell
    through to a 16-dof euclidean block on Sim3 wrappers)."""
    S_rel = Sim3.exp(torch.from_numpy(rng.normal(size=7) * 0.2))
    prob = Problem(Options(method="lm", max_iters=50), dtype=F64, device="cpu")
    prob.add_residual_block(PoseResidual(Sim3.exp(torch.zeros(7, dtype=F64)), 10.0), ["a"])
    prob.add_residual_block(PoseToPoseResidual(S_rel, 5.0), ["a", "b"])
    prob.initialize_params({"a": Sim3.exp(torch.from_numpy(rng.normal(size=7) * 0.1)),
                            "b": Sim3.exp(torch.from_numpy(rng.normal(size=7) * 0.1))})
    out = prob.solve()
    assert isinstance(out["b"], Sim3)
    assert float(prob.eval_cost()) < 1e-16
    np.testing.assert_allclose(out["a"].mat.numpy(), np.eye(4), atol=1e-9)
    np.testing.assert_allclose(out["b"].mat.numpy(), S_rel.mat.numpy(), atol=1e-9)


def _graphs(make, **kw):
    """The port's and the JAX package's Sim(3) pose graph of one dataset."""
    data = make(synth)
    jdata = make(jsynth)
    return data, build.sim3_pose_graph(data, dtype=F64, device="cpu", **kw), jbuild.sim3_pose_graph(
        jdata, dtype=jnp.float64, **kw)


def test_recovers_consistent_graph():
    """Exactly consistent measurements and a perturbed init: exact recovery."""
    def make(m):
        data = m.sim3_loop(n_poses=40, n_loops=4, gt_scale_std=0.3, seed=3)
        data.T_meas = np.stack([data.T_gt[j] @ m._sim3_inv(data.T_gt[i]) for i, j in zip(data.edges_i, data.edges_j)])
        perturb = random_xi(np.random.default_rng(7), 0.05, (40,))
        perturb[0] = 0.0
        data.T_init = np.asarray(jsim3.exp(jnp.asarray(perturb))) @ data.T_gt
        return data

    data, g, jg = _graphs(make)
    opts = dict(method="lm", max_iters=30)
    g2, info = solve(g, Options(**opts))
    _, j_info = jlm.solve(jg, jlm.Options(**opts))
    assert info.chi2.item() < 1e-12 and float(j_info.chi2) < 1e-12
    err = sim3.log(torch.from_numpy(data.T_gt) @ sim3.inv(g2.blocks["poses"].values))
    assert err.abs().max().item() < 1e-6


def test_scale_drift_correction():
    """Monocular drift of 0.01 log-scale an edge: the loop closures pull the
    scale back and the ATE falls by an order of magnitude."""
    kw = dict(n_poses=120, n_loops=6, scale_drift=0.01, odo_scale_std=0.005, seed=0)
    data, g, jg = _graphs(lambda m: m.sim3_loop(**kw))
    assert sim3.scale(torch.from_numpy(data.T_init)).max().item() > 2.0  # the drift accumulated
    chi2_0 = g.chi2().item()
    chi2_gt = build.sim3_pose_graph(data, dtype=F64, device="cpu", init="gt").chi2().item()
    opts = dict(method="lm", max_iters=50)
    g2, info = solve(g, Options(**opts))
    _, j_info = jlm.solve(jg, jlm.Options(**opts))
    np.testing.assert_allclose(info.chi2.item(), float(j_info.chi2), rtol=1e-8)
    assert info.chi2.item() < chi2_gt * 1.2 and chi2_gt < chi2_0 * 0.01
    assert sim3.scale(g2.blocks["poses"].values).max().item() < 1.6
    t_est = g2.blocks["poses"].values.numpy()[:, :3, 3]
    ate_init = np.linalg.norm(data.T_init[:, :3, 3] - data.T_gt[:, :3, 3], axis=-1)
    ate_opt = np.linalg.norm(t_est - data.T_gt[:, :3, 3], axis=-1)
    assert ate_opt.mean() < ate_init.mean() / 5.0


def test_ell_path_matches_dense():
    """The ELL PCG path is dof-generic: 7-dof blocks go through
    ``build_ell_direct`` / ``solve_ell`` unchanged."""
    _, g, jg = _graphs(lambda m: m.sim3_loop(n_poses=80, n_loops=6, scale_drift=0.005, seed=2))
    opts = dict(method="lm", max_iters=40)
    _, i_d = solve(g, Options(**opts))
    _, i_e = bcsr.solve_ell(g, Options(**opts), plan=bcsr.build_ell_direct(g))
    np.testing.assert_allclose(i_e.chi2.item(), i_d.chi2.item(), rtol=1e-3)
    from pyslam_tpu.solver.bcsr import solve_ell as j_solve_ell

    _, j_e = j_solve_ell(jg, jlm.Options(**opts))
    np.testing.assert_allclose(i_e.chi2.item(), float(j_e.chi2), rtol=1e-8)


def test_route_auto_large_sim3():
    kw = dict(n_poses=2500, n_loops=40, scale_drift=0.002, seed=1)
    g = build.sim3_pose_graph(synth.sim3_loop(**kw), dtype=torch.float32, device="cpu")
    jg = jbuild.sim3_pose_graph(jsynth.sim3_loop(**kw), dtype=jnp.float32)
    assert route_auto(g) == jsolver.route_auto(jg) == "ell"


def test_gauge_anchoring():
    data, g, jg = _graphs(lambda m: m.sim3_loop(n_poses=30, n_loops=2, seed=1))
    g2, _ = solve(g, Options(method="lm", max_iters=20))
    np.testing.assert_allclose(g2.blocks["poses"].values[0].numpy(), data.T_init[0], atol=1e-12)


def test_chi2_matches_independent_scipy_solver():
    kw = dict(n_poses=25, n_loops=3, scale_drift=0.01, odo_scale_std=0.005, seed=4)
    data, g, jg = _graphs(lambda m: m.sim3_loop(**kw))
    opts = dict(method="lm", max_iters=50)
    _, info = solve(g, Options(**opts))
    _, j_info = jlm.solve(jg, jlm.Options(**opts))
    _, chi2_ref, _ = scipy_ref.solve_pose_graph(data, max_iters=60)
    np.testing.assert_allclose(info.chi2.item(), chi2_ref, rtol=1e-5)
    np.testing.assert_allclose(info.chi2.item(), float(j_info.chi2), rtol=1e-10)


def test_marginals_vs_dense_inverse():
    _, g, _ = _graphs(lambda m: m.sim3_loop(n_poses=15, n_loops=2, seed=6))
    g2, _ = solve(g, Options(method="lm", max_iters=30))
    C = full_covariance(g2).numpy()
    margs = marginal_covariances(g2, pcg_rtol=1e-10).numpy()
    for i in range(1, 15):  # pose 0 is anchored
        np.testing.assert_allclose(margs[i], C[7 * i : 7 * i + 7, 7 * i : 7 * i + 7], atol=1e-6)


def test_sim3_landmark_graph_through_schur_routing():
    """A Sim(3)-pose landmark graph built with an autodiff factor alone goes
    through the dof-generic Schur route (7-dof poses eliminated against
    3-dof landmarks) and converges."""
    if "sim3_landmark_xyz" not in FACTOR_KERNELS:
        def resid(data, S, l):
            return torch.einsum("...ij,...j->...i", S[..., :3, :3], l) + S[..., :3, 3] - data["obs"]

        register_autodiff_factor("sim3_landmark_xyz", resid, ("sim3", "euclidean"))
    rng = np.random.default_rng(0)
    n, L = 6, 30
    S_gt = np.stack([np.eye(4)] * n)
    for k in range(n):
        S_gt[k][:3, 3] = [-k, 0, 0]
    lm = rng.uniform(-1, 1, (L, 3)) + [2, 0, 0]
    oi, oj = np.repeat(np.arange(n), L), np.tile(np.arange(L), n)
    obs = np.einsum("mij,mj->mi", S_gt[oi][:, :3, :3], lm[oj]) + S_gt[oi][:, :3, 3] + rng.normal(0, 0.005, (n * L, 3))
    blocks = {"poses": VariableBlock.create("sim3", torch.from_numpy(S_gt), torch.from_numpy(np.eye(n, dtype=bool)[0])),
              "landmarks": VariableBlock.create("euclidean", torch.from_numpy(lm + rng.normal(0, 0.1, lm.shape)))}
    g = FactorGraph(blocks, [FactorBatch.create("sim3_landmark_xyz", ("poses", "landmarks"), (oi, oj),
                                                {"obs": torch.from_numpy(obs)}, L2Loss())])
    assert route_auto(g) == "schur_dense"
    _, info = solve_auto(g, Options(method="lm", max_iters=15))
    assert info.chi2.item() < 0.01 * g.chi2().item()
