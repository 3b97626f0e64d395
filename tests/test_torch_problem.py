"""The Ceres-style Problem API of the torch port (``problem.py``) against
the JAX reference's ``Problem``, in f64 on the CPU: the cases of
``tests/test_problem.py`` and the four ``Problem`` cases of
``tests/test_covariance.py``, each problem built in both packages from the
same numpy inputs.

Tolerances: solved parameters and costs within 1e-8 of the reference's
(relative to the largest entry, absolute below 1); ``solve_one_iter``'s
update norm 1e-8 relative; covariance blocks, dense and lazy, 1e-8 of the
largest entry.  Also: the built graph is ``build.pose_graph``'s tensor for
tensor, the landmark-first observation order that the reference refuses
in lazy covariance (ROADMAP, reference faults), and
``marginalize_parameters`` followed by a solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyslam_tpu as J
import pyslam_tpu_torch as T
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu_torch.graph import build, register_autodiff_factor
from pyslam_tpu_torch.graph.core import FACTOR_KERNELS
from pyslam_tpu_torch.io import synth
from pyslam_tpu_torch.residuals import _ResidualBase
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

REL = 1e-8
CAM = dict(cu=320.0, cv=240.0, fu=500.0, fv=500.0, b=0.25, w=640, h=480)


def _np(x):
    x = getattr(x, "mat", x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(out, ref, rel=REL):
    ref, out = _np(ref), _np(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1.0))


def _problem(pkg, options):
    if pkg is T:
        return T.Problem(T.Options(**options), dtype=torch.float64, device="cpu")
    return J.Problem(J.Options(**options), dtype=jnp.float64)


def _both(make):
    """``make(pkg)`` for the reference and the port: (jax, torch)."""
    return make(J), make(T)


def _assert_params(tp, jp, rel=REL):
    assert set(tp.param_dict) == set(jp.param_dict)
    for k in jp.param_dict:
        _close(tp.param_dict[k], jp.param_dict[k], rel)


# --------------------------------------------------------------------------
# tests/test_problem.py
# --------------------------------------------------------------------------


def _curve_fit(pkg):
    rng = np.random.default_rng(42)
    truth = np.array([1.5, -0.5, 2.0])
    problem = _problem(pkg, dict(method="gn", max_iters=10))
    for _ in range(60):
        x = rng.uniform(-2, 2)
        y = truth[0] * x * x + truth[1] * x + truth[2] + rng.normal(0, 0.02)
        problem.add_residual_block(pkg.QuadraticResidual(x, y, 50.0), ["params"])
    problem.initialize_params({"params": np.zeros(3)})
    return problem


def test_curve_fit():
    jp, tp = _both(_curve_fit)
    jp.solve()
    sol = tp.solve()
    _assert_params(tp, jp)
    np.testing.assert_allclose(_np(sol["params"]), [1.5, -0.5, 2.0], atol=0.05)
    assert tp.summary.iterations == int(jp.summary.iterations)


def _ring(pkg, loss=None, n=12):
    """``tests/test_problem.py``'s SE(2) ring: odometry and one loop
    closure, noisy initial poses, pose 0 constant."""
    rng = np.random.default_rng(42)
    step = np.asarray(J.lie.se2.exp(jnp.asarray([1.0, 0.0, 2 * np.pi / n])))
    Ts = [np.eye(3)]
    for _ in range(1, n):
        Ts.append(step @ Ts[-1])
    problem = _problem(pkg, dict(method="lm", max_iters=50))
    params = {}
    for k, Tk in enumerate(Ts):
        noise = rng.normal(0, 0.1, 3) if k else np.zeros(3)
        params[f"T_{k}_0"] = pkg.SE2(np.asarray(J.lie.se2.exp(jnp.asarray(noise))) @ Tk)
    make_loss = (lambda: None) if loss is None else (lambda: getattr(pkg, loss)(2.0))
    for k in range(1, n):
        problem.add_residual_block(pkg.PoseToPoseResidual(pkg.SE2(Ts[k] @ np.linalg.inv(Ts[k - 1])), 10.0),
                                   [f"T_{k-1}_0", f"T_{k}_0"], make_loss())
    problem.add_residual_block(pkg.PoseToPoseResidual(pkg.SE2(Ts[0] @ np.linalg.inv(Ts[n - 1])), 10.0),
                               [f"T_{n-1}_0", "T_0_0"], make_loss())
    problem.initialize_params(params)
    problem.set_parameters_constant("T_0_0")
    return problem


@pytest.mark.parametrize("loss", [None, "CauchyLoss"])
def test_relaxation_matches_reference(loss):
    jp, tp = _both(lambda pkg: _ring(pkg, loss))
    c0 = tp.eval_cost()
    assert abs(c0 - jp.eval_cost()) <= REL * c0
    T0 = tp.param_dict["T_0_0"].mat.clone()
    jp.solve()
    tp.solve()
    _assert_params(tp, jp)
    assert tp.eval_cost() < c0 * (1e-3 if loss is None else 1e-2)
    assert torch.equal(tp.param_dict["T_0_0"].mat, T0) and isinstance(tp.param_dict["T_3_0"], T.SE2)


def test_solve_one_iter_matches_reference():
    jp, tp = _both(_ring)
    c0 = tp.eval_cost()
    norm, jnorm = tp.solve_one_iter(), jp.solve_one_iter()
    assert norm > 0 and abs(norm - jnorm) <= REL * jnorm
    _assert_params(tp, jp)
    assert tp.eval_cost() < c0
    # eval_cost at given params leaves the problem's own untouched
    assert tp.eval_cost({"T_3_0": tp.param_dict["T_4_0"]}) != tp.eval_cost()


def _triangulation(pkg):
    rng = np.random.default_rng(42)
    T1 = np.eye(4)
    T2 = np.asarray(J.lie.se3.exp(jnp.asarray([1.0, 0.0, 0.0, 0.0, 0.1, 0.0])))
    cam = J.StereoCamera(**CAM)
    pts = np.stack([rng.uniform(-2, 2, 20), rng.uniform(-1, 1, 20), rng.uniform(4, 9, 20)], -1)
    problem = _problem(pkg, dict(method="lm", max_iters=40))
    params = {"T_1": pkg.SE3(T1), "T_2": pkg.SE3(T2)}
    for i, p in enumerate(pts):
        params[f"pt_{i}"] = p + rng.normal(0, 0.2, 3)
        for name, Tc in (("T_1", T1), ("T_2", T2)):
            obs = np.asarray(cam.project(J.lie.se3.act(jnp.asarray(Tc), jnp.asarray(p))))
            problem.add_residual_block(pkg.ReprojectionResidual(pkg.StereoCamera(**CAM), obs, 1.0),
                                       [name, f"pt_{i}"])
    problem.initialize_params(params)
    problem.set_parameters_constant(["T_1", "T_2"])
    return problem, pts


def test_two_view_triangulation():
    (jp, _), (tp, pts) = _both(_triangulation)
    jp.solve()
    sol = tp.solve()
    _assert_params(tp, jp)
    np.testing.assert_allclose(np.stack([_np(sol[f"pt_{i}"]) for i in range(20)]), pts, atol=1e-3)
    assert len(tp._build().batches) == 1  # one camera, one batch


def test_prior_covariance_is_inverse_information():
    rng = np.random.default_rng(42)
    stiff = np.diag(rng.uniform(1.0, 3.0, 6))
    T_obs = np.asarray(J.lie.se3.exp(jnp.asarray(rng.normal(size=6) * 0.3)))

    def make(pkg):
        problem = _problem(pkg, dict(method="gn", max_iters=5))
        problem.add_residual_block(pkg.PoseResidual(pkg.SE3(T_obs), stiff), ["T"])
        problem.initialize_params({"T": pkg.SE3(T_obs)})
        problem.solve()
        return problem.get_covariance_block("T", "T")

    jcov, tcov = _both(make)
    _close(tcov, jcov)
    np.testing.assert_allclose(_np(tcov), np.linalg.inv(stiff.T @ stiff), atol=1e-10)


def _full_slam(pkg):
    data = jsynth.ba_synthetic(n_cams=5, n_pts=30, obs_per_pt=3, seed=2)
    prob = _problem(pkg, dict(max_iters=25))
    poses, pts = [f"T_{c}" for c in range(5)], [f"p_{l}" for l in range(30)]
    cam = pkg.StereoCamera(**data.camera)
    for k in range(len(data.cam_idx)):
        prob.add_residual_block(pkg.ReprojectionResidual(cam, data.obs[k], 2.0),
                                [poses[int(data.cam_idx[k])], pts[int(data.pt_idx[k])]])
    for c in range(4):
        prob.add_residual_block(pkg.PoseToPoseResidual(data.T_gt[c + 1] @ np.linalg.inv(data.T_gt[c]), 10.0),
                                [poses[c], poses[c + 1]])
    prob.initialize_params({n: pkg.SE3(Tc) for n, Tc in zip(poses, data.T_init)})
    prob.initialize_params(dict(zip(pts, data.pts_init)))
    prob.set_parameters_constant(poses[0])
    return prob


def test_mixed_reprojection_and_odometry():
    jp, tp = _both(_full_slam)
    before = tp.eval_cost()
    jp.solve()
    tp.solve()
    assert tp.eval_cost() < before * 0.1
    assert abs(tp.eval_cost() - jp.eval_cost()) <= REL * jp.eval_cost()
    _assert_params(tp, jp, 1e-6)


def test_parameter_kind_is_checked_by_name():
    problem = T.Problem(device="cpu")
    problem.add_residual_block(T.PoseResidual(np.eye(3), 1.0), ["T"])
    problem.initialize_params({"T": np.eye(3)})
    with pytest.raises(ValueError, match="expects a 'se2' parameter but 'T'"):
        problem.solve()


# --------------------------------------------------------------------------
# tests/test_covariance.py's Problem cases
# --------------------------------------------------------------------------


def _loop_problem(pkg, n, seed, n_loops, cholesky_info):
    data = jsynth.se2_loop(n_poses=n, n_loops=n_loops, seed=seed)
    names = [f"T_{i}" for i in range(n)]
    problem = _problem(pkg, dict(max_iters=30))
    for k in range(len(data.edges_i)):
        S = data.sqrt_info[k]
        problem.add_residual_block(pkg.PoseToPoseResidual(data.T_meas[k], np.linalg.cholesky(S @ S.T)
                                                          if cholesky_info else S),
                                   [names[int(data.edges_i[k])], names[int(data.edges_j[k])]])
    problem.initialize_params({nm: pkg.SE2(Tk) for nm, Tk in zip(names, data.T_init)})
    problem.set_parameters_constant(names[0])
    problem.solve()
    return problem


def _ba_problem(pkg):
    data = jsynth.ba_synthetic(n_cams=5, n_pts=20, obs_per_pt=3, seed=6)
    cam = pkg.StereoCamera(**data.camera)
    prob = _problem(pkg, dict(max_iters=25))
    poses, pts = [f"T_{c}" for c in range(5)], [f"p_{l}" for l in range(20)]
    for k in range(len(data.cam_idx)):
        prob.add_residual_block(pkg.ReprojectionResidual(cam, data.obs[k], 2.0),
                                [poses[int(data.cam_idx[k])], pts[int(data.pt_idx[k])]])
    prob.initialize_params({n: pkg.SE3(Tc) for n, Tc in zip(poses, data.T_init)})
    prob.initialize_params(dict(zip(pts, data.pts_init)))
    prob.set_parameters_constant(poses[:2])
    prob.solve()
    return prob


@pytest.fixture(scope="module")
def solved():
    """The solved covariance problems of both packages, built once."""
    return {
        "loop8": _both(lambda pkg: _loop_problem(pkg, 8, 1, 2, True)),
        "loop12": _both(lambda pkg: _loop_problem(pkg, 12, 4, 3, False)),
        "ba": _both(_ba_problem),
    }


def test_problem_covariance_block(solved):
    jp, tp = solved["loop8"]
    _assert_params(tp, jp)
    assert tp.compute_covariance().shape == (24, 24)
    jp.compute_covariance()
    blk = tp.get_covariance_block("T_3", "T_3")
    _close(blk, jp.get_covariance_block("T_3", "T_3"))
    assert blk.shape == (3, 3) and (np.linalg.eigvalsh(_np(blk)) > 0).all()


@pytest.mark.parametrize("case,pairs", [("loop12", [("T_3", "T_7")]),
                                        ("ba", [("p_3", "p_3"), ("p_3", "p_9"), ("T_2", "p_3"), ("p_3", "T_2"),
                                                ("T_2", "T_4")])])
def test_dense_and_lazy_blocks_match_reference(solved, case, pairs):
    jp, tp = solved[case]
    _assert_params(tp, jp, 1e-7)
    for limit in (8192, 4):
        lazy = tp.compute_covariance(dense_dof_limit=limit) is None
        assert lazy == (limit == 4) and (jp.compute_covariance(dense_dof_limit=limit) is None) == lazy
        for a, b in pairs:
            _close(tp.get_covariance_block(a, b), jp.get_covariance_block(a, b))


def test_landmark_first_observations_answer_as_pose_first(solved):
    """A (landmark, pose) observation factor, registered with
    ``register_autodiff_factor``, through ``Problem``: the lazy covariance
    blocks are those of the (pose, landmark) problem.  The reference gates
    on the (pose, landmark) order and raises here."""
    kernel = FACTOR_KERNELS["reprojection"]

    def landmark_first(data, pt, Tc):
        return kernel(data, Tc, pt, compute_jacobians=False)[0]

    register_autodiff_factor("reprojection_landmark_first", landmark_first, ("euclidean", "se3"))

    class LandmarkFirst(_ResidualBase):
        factor_kind = "reprojection_landmark_first"
        param_kinds = ("euclidean", "se3")

        def __init__(self, inner):
            self.inner = inner

        def batch_data(self):
            return self.inner.batch_data()

    _, ref = solved["ba"]
    flipped = T.Problem(ref.options, dtype=torch.float64, device="cpu")
    for residual, keys, loss in ref.residual_blocks:
        flipped.add_residual_block(LandmarkFirst(residual), keys[::-1], loss)
    flipped.initialize_params(dict(ref.param_dict))
    flipped.set_parameters_constant(ref.constant_param_keys)
    assert flipped._build().batches[0].slots == ("euclidean_3", "se3_4x4")
    assert flipped.compute_covariance(dense_dof_limit=4) is None and ref.compute_covariance(dense_dof_limit=4) is None
    for a, b in (("T_2", "T_4"), ("p_3", "p_9"), ("T_2", "p_3")):
        _close(flipped.get_covariance_block(a, b), ref.get_covariance_block(a, b), 1e-9)

    jref = solved["ba"][0]
    jflipped = J.Problem(jref.options, dtype=jnp.float64)
    J.graph.register_autodiff_factor(
        "reprojection_landmark_first",
        lambda data, pt, Tc: J.graph.core.FACTOR_KERNELS["reprojection"](data, Tc, pt, compute_jacobians=False)[0],
        ("euclidean", "se3"))
    for residual, keys, loss in jref.residual_blocks:
        jr = LandmarkFirst(residual)
        jflipped.add_residual_block(jr, keys[::-1], loss)
    jflipped.initialize_params(dict(jref.param_dict))
    jflipped.set_parameters_constant(jref.constant_param_keys)
    assert jflipped.compute_covariance(dense_dof_limit=4) is None
    with pytest.raises(ValueError, match="lazy covariance supports"):
        jflipped.get_covariance_block("T_2", "T_4")


def test_marginalize_parameters_then_solve():
    def make(pkg):
        problem = _ring(pkg)
        problem.solve()
        problem.marginalize_parameters(["T_5_0", "T_6_0"])
        problem.add_residual_block(pkg.PoseToPoseResidual(pkg.SE2(np.eye(3)), 10.0), ["T_4_0", "T_7_0"])
        problem.solve()
        return problem

    jp, tp = _both(make)
    assert "T_5_0" not in tp.param_dict and type(tp.residual_blocks[-2][0]).__name__ == "DensePriorResidual"
    assert [type(r[0]).__name__ for r in tp.residual_blocks] == [type(r[0]).__name__ for r in jp.residual_blocks]
    _assert_params(tp, jp)
    assert abs(tp.eval_cost() - jp.eval_cost()) <= REL * max(jp.eval_cost(), 1.0)


def test_built_graph_is_the_builders_graph():
    """A pose graph through Problem builds build.pose_graph's tensors (the
    chip smoke holds sphere2500 to this): values, masks, indices and data
    equal, in f32."""
    data = synth.se3_sphere(n_poses=30, seed=0)
    g = build.pose_graph(data, device="cpu")
    problem = T.Problem(T.Options(), device="cpu")
    names = [f"x{i}" for i in range(30)]
    problem.initialize_params({n: T.SE3(Tk) for n, Tk in zip(names, data.T_init)})
    for i, j, Tm, S in zip(data.edges_i, data.edges_j, data.T_meas, data.sqrt_info):
        problem.add_residual_block(T.PoseToPoseResidual(T.SE3(Tm), S), [names[i], names[j]])
    problem.set_parameters_constant(names[0])
    pg = problem._build()
    (pb,), (gb,) = pg.blocks.values(), g.blocks.values()
    assert torch.equal(pb.values, gb.values) and torch.equal(pb.const_mask, gb.const_mask)
    (pf,), (gf,) = pg.batches, g.batches
    assert pf.kind == gf.kind and all(torch.equal(a, b) for a, b in zip(pf.indices, gf.indices))
    assert torch.equal(pf.weight, gf.weight) and all(torch.equal(pf.data[k], gf.data[k]) for k in gf.data)
