"""The twin of ``tests/test_landmark_slam.py``: 2D landmark SLAM (and the 3D
relative-position landmark factor) through the port, on the reference's own
problems, in f64 on the CPU, at the reference test's tolerances, beside the
JAX package's solves and the independent scipy GN of ``tests/scipy_ref.py``.

Held here: ``::test_solve_matches_scipy_reference`` (both observation
types), ``::test_g2o_landmark_roundtrip`` (the solve of the file read back),
``::test_problem_api_wrappers``, ``::test_problem_rejects_raw_pose_arrays``,
``::test_gnc_rejects_wrong_associations``,
``::test_covariances_on_2dof_landmarks``,
``::test_landmark_xyz_se3_jacobians_and_solve`` (the solve; the Jacobians
are held as below).

Held by other port files:
  * ``::test_jacobians_vs_autodiff`` (``landmark_xy_se2``,
    ``bearing_range_se2``) and the Jacobians of ``landmark_xyz_se3``:
    ``test_torch_ba_factors.py::test_factor_kernel_matches_reference``
    (residuals and Jacobians within 1e-10 of the reference's analytic ones,
    which the reference holds to ``jax.jacfwd``);
  * ``::test_bearing_wrap_boundary``: ``test_torch_ba_factors.py::test_bearing_wraps_at_pi``;
  * ``::test_routes_through_dof_generic_schur``:
    ``test_torch_solve_auto.py::test_route_of_real_graphs_is_the_reference_route``
    (``landmark_slam_30``, the reference's graph: route ``schur_dense``);
    the block widths (3-dof poses, 2-dof landmarks) here, in
    ``test_solve_matches_scipy_reference``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy_ref import solve_landmark_slam_2d

from pyslam_tpu import solver as jsolver
from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu_torch import SE2, BearingRangeResidual, PoseToPoseResidual, Problem
from pyslam_tpu_torch.graph import FactorBatch, FactorGraph, VariableBlock, build
from pyslam_tpu_torch.io import g2o, synth
from pyslam_tpu_torch.losses import L2Loss
from pyslam_tpu_torch.solver import (
    Options,
    full_covariance,
    landmark_marginal_covariances,
    pose_covariance_block,
    pose_marginal_covariances,
    route_auto,
    solve_auto,
    solve_gnc,
)
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _unload_compiled_programs():
    yield
    jax.clear_caches()


def _positions(T):
    """Body-to-world positions of world-to-body SE(2) poses."""
    return np.stack([np.linalg.inv(Tk)[:2, 2] for Tk in np.asarray(T)])


def _ate(T, T_gt):
    return np.sqrt(np.mean(np.sum((_positions(T) - _positions(T_gt)) ** 2, axis=1)))


@pytest.mark.parametrize("obs_type", ["bearing_range", "xy"])
def test_solve_matches_scipy_reference(obs_type):
    kw = dict(n_poses=40, n_landmarks=25, max_range=8.0, obs_type=obs_type, seed=3)
    data = synth.landmark_slam_2d(**kw)
    g = build.landmark_slam_2d(data, dtype=F64, device="cpu")
    assert (g.blocks["poses"].dof, g.blocks["landmarks"].dof) == (3, 2)
    assert route_auto(g) == "schur_dense"
    opts = dict(method="gn", max_iters=25)
    solved, info = solve_auto(g, Options(**opts))
    _, j_info = jsolver.solve_auto(jbuild.landmark_slam_2d(jsynth.landmark_slam_2d(**kw), dtype=jnp.float64),
                                   jlm.Options(**opts))
    _, _, chi2_ref, _ = solve_landmark_slam_2d(data, max_iters=25)
    assert info.chi2.item() <= chi2_ref * (1 + 1e-6) + 1e-9
    np.testing.assert_allclose(info.chi2.item(), float(j_info.chi2), rtol=1e-8)
    assert _ate(solved.blocks["poses"].values, data.T_gt) < 0.5 * _ate(data.T_init, data.T_gt)


def test_g2o_landmark_roundtrip(tmp_path):
    """The file read back (through the native scanner) solves to the same
    optimum as the original arrays."""
    data = synth.landmark_slam_2d(n_poses=25, n_landmarks=15, obs_type="xy", seed=5)
    path = tmp_path / "lm2d.g2o"
    g2o.write_g2o_landmarks(path, data)
    back = g2o.read_g2o(path)
    assert back.obs_type == "xy"
    for f in ("T_init", "lm_init", "obs", "T_meas"):
        np.testing.assert_allclose(getattr(back, f), getattr(data, f), rtol=1e-6, atol=1e-7)
    opts = Options(method="gn", max_iters=15)
    _, info_a = solve_auto(build.landmark_slam_2d(data, dtype=F64, device="cpu"), opts)
    _, info_b = solve_auto(build.landmark_slam_2d(back, dtype=F64, device="cpu"), opts)
    np.testing.assert_allclose(info_a.chi2.item(), info_b.chi2.item(), rtol=1e-6)


def _landmark_problem(data, options):
    """The object API: the problem through ``Problem.add_residual_block``."""
    problem = Problem(options, dtype=F64, device="cpu")
    params = {f"T{k}": SE2(torch.from_numpy(T)) for k, T in enumerate(data.T_init)}
    params.update({f"l{k}": torch.from_numpy(l) for k, l in enumerate(data.lm_init)})
    for e in range(len(data.edges_i)):
        problem.add_residual_block(PoseToPoseResidual(data.T_meas[e], data.sqrt_info[e]),
                                   [f"T{data.edges_i[e]}", f"T{data.edges_j[e]}"])
    for m in range(len(data.obs_pose)):
        problem.add_residual_block(BearingRangeResidual(data.obs[m], data.obs_sqrt_info[m]),
                                   [f"T{data.obs_pose[m]}", f"l{data.obs_lm[m]}"])
    problem.initialize_params(params)
    problem.set_parameters_constant("T0")
    return problem


def test_problem_api_wrappers():
    """The same problem through ``Problem`` and as the batched graph."""
    kw = dict(n_poses=12, n_landmarks=8, max_range=8.0, obs_type="bearing_range", seed=7)
    data = synth.landmark_slam_2d(**kw)
    problem = _landmark_problem(data, Options(max_iters=20))
    problem.solve()
    _, info = solve_auto(build.landmark_slam_2d(data, dtype=F64, device="cpu"), Options(method="lm", max_iters=20))
    np.testing.assert_allclose(problem.eval_cost(), info.chi2.item(), rtol=1e-6)
    _, j_info = jsolver.solve_auto(jbuild.landmark_slam_2d(jsynth.landmark_slam_2d(**kw), dtype=jnp.float64),
                                   jlm.Options(method="lm", max_iters=20))
    np.testing.assert_allclose(info.chi2.item(), float(j_info.chi2), rtol=1e-8)


def test_problem_rejects_raw_pose_arrays():
    """A pose given as a raw array is a 'euclidean' parameter; the solve
    refuses it."""
    data = synth.landmark_slam_2d(n_poses=4, n_landmarks=3, max_range=8.0, seed=7)
    problem = Problem(device="cpu")
    problem.add_residual_block(BearingRangeResidual(data.obs[0], data.obs_sqrt_info[0]), ["T0", "l0"])
    problem.initialize_params({"T0": torch.from_numpy(data.T_init[0]), "l0": torch.from_numpy(data.lm_init[0])})
    with pytest.raises(ValueError, match="expects a 'se2' parameter"):
        problem.solve()


def test_gnc_rejects_wrong_associations():
    """Six observations given the wrong landmark: GNC flags each of them,
    few others, and the trajectory stays near the clean solve's."""
    data = synth.landmark_slam_2d(n_poses=60, n_landmarks=40, max_range=10.0, obs_type="bearing_range", seed=11)
    rng = np.random.default_rng(0)
    M = len(data.obs_pose)
    bad = rng.choice(M, size=6, replace=False)
    obs_lm = np.array(data.obs_lm)
    L = int(obs_lm.max()) + 1
    for m in bad:
        obs_lm[m] = (obs_lm[m] + 1 + rng.integers(L - 1)) % L
    corrupted = dataclasses.replace(data, obs_lm=obs_lm)
    g = build.landmark_slam_2d(corrupted, dtype=F64, device="cpu")
    solved, info = solve_gnc(g, Options(method="lm", max_iters=10), robustify=[0])
    flagged = set(np.flatnonzero(np.asarray(info.weights[0]) < 0.5).tolist())
    assert set(bad.tolist()) <= flagged
    assert len(flagged) <= 0.05 * M
    clean, _ = solve_auto(build.landmark_slam_2d(data, dtype=F64, device="cpu"), Options(method="lm", max_iters=15))
    assert _ate(solved.blocks["poses"].values, data.T_gt) < 3 * _ate(clean.blocks["poses"].values, data.T_gt) + 0.05


def test_covariances_on_2dof_landmarks():
    """Pose and landmark marginals and cross blocks on a 2-dof landmark
    graph equal the dense inverse (sorted-name layout: the 10 landmarks'
    20 dofs first, then the poses)."""
    kw = dict(n_poses=15, n_landmarks=10, max_range=9.0, seed=2)
    g = build.landmark_slam_2d(synth.landmark_slam_2d(**kw), dtype=F64, device="cpu")
    solved, info = solve_auto(g, Options(method="gn", max_iters=20))
    _, j_info = jsolver.solve_auto(jbuild.landmark_slam_2d(jsynth.landmark_slam_2d(**kw), dtype=jnp.float64),
                                   jlm.Options(method="gn", max_iters=20))
    np.testing.assert_allclose(info.chi2.item(), float(j_info.chi2), rtol=1e-8)
    Sig = full_covariance(solved).numpy()
    P = pose_marginal_covariances(solved).numpy()
    np.testing.assert_allclose(P[3], Sig[29:32, 29:32], rtol=1e-8)
    L = landmark_marginal_covariances(solved, np.arange(10)).numpy()
    np.testing.assert_allclose(L[4], Sig[8:10, 8:10], rtol=1e-8)
    B = pose_covariance_block(solved, 2, 5).numpy()
    np.testing.assert_allclose(B, Sig[26:29, 35:38], rtol=1e-8)


def test_landmark_xyz_se3_solve():
    """A small 3D landmark SLAM graph (8 poses on a line, 12 landmarks,
    body-frame landmark positions) through the Schur route to the noise
    floor."""
    rng = np.random.default_rng(9)
    n, L = 8, 12
    T_gt = np.stack([np.eye(4) for _ in range(n)])
    for k in range(n):
        T_gt[k][:3, 3] = [-0.5 * k, 0, 0]
    lm_gt = rng.uniform(-1, 1, (L, 3)) + np.array([2.0, 0, 0])
    oi, oj = np.repeat(np.arange(n), L), np.tile(np.arange(L), n)
    p_local = np.einsum("mij,mj->mi", T_gt[oi][:, :3, :3], lm_gt[oj]) + T_gt[oi][:, :3, 3]
    obs = p_local + rng.normal(0, 0.01, p_local.shape)
    blocks = {"poses": VariableBlock.create("se3", torch.from_numpy(T_gt), torch.from_numpy(np.eye(n, dtype=bool)[0])),
              "landmarks": VariableBlock.create("euclidean", torch.from_numpy(lm_gt + rng.normal(0, 0.2, lm_gt.shape)))}
    batch = FactorBatch.create("landmark_xyz_se3", ("poses", "landmarks"), (oi, oj),
                               {"obs": torch.from_numpy(obs),
                                "sqrt_info": torch.from_numpy(np.tile(np.eye(3) * 100, (len(oi), 1, 1)))}, L2Loss())
    solved, info = solve_auto(FactorGraph(blocks, [batch]), Options(method="lm", max_iters=15))
    assert info.chi2.item() < 0.75 * len(oi) * 3  # E[chi2] ~ half the residual count
    assert np.abs(solved.blocks["landmarks"].values.numpy() - lm_gt).max() < 0.02
