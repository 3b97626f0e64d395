"""The residual library of the torch port (``pyslam_tpu_torch/residuals.py``)
against the JAX reference (``pyslam_tpu/residuals.py``), in f64 on the
CPU: every class built from the same numpy measurement in both packages,
``evaluate`` at the same numpy parameters, the residual and every Jacobian
within 1e-12 of the reference's (relative to the largest reference entry,
absolute below 1).  Also the reference's own checks of
``tests/test_residuals.py``: each Jacobian against forward-mode autodiff of
``evaluate`` through the left perturbation (``torch.func.jacfwd``, 1e-9),
zero residuals at consistent poses, the selective Jacobians, and the host
storage of the measurements.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyslam_tpu.residuals as JR
import pyslam_tpu_torch.residuals as TR
from pyslam_tpu import imu as jimu
from pyslam_tpu.graph.marginalize import _ensure_dense_prior_kernel as j_prior_kernel
from pyslam_tpu.lie import SE2 as JSE2, SE3 as JSE3, Sim3 as JSim3, se2 as jse2, se3 as jse3, sim3 as jsim3
from pyslam_tpu.sensors import RGBDCamera as JRGBD, StereoCamera as JStereo
from pyslam_tpu_torch import imu as timu
from pyslam_tpu_torch.graph.marginalize import _ensure_dense_prior_kernel as t_prior_kernel
from pyslam_tpu_torch.lie import SE2, SE3, Sim3
from pyslam_tpu_torch.sensors import RGBDCamera, StereoCamera
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

TOL = 1e-12
CAM = dict(cu=320.0, cv=240.0, fu=500.0, fv=480.0, b=0.25, w=640, h=480)
RGBD = dict(cu=320.0, cv=240.0, fu=500.0, fv=480.0, w=640, h=480)


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    out = out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1.0))


def _pose(kind, rng, scale=0.5):
    """A numpy group element of ``kind`` from a seeded tangent vector."""
    dof = {"se2": 3, "se3": 6, "sim3": 7}[kind]
    ops = {"se2": jse2, "se3": jse3, "sim3": jsim3}[kind]
    return np.asarray(ops.exp(jnp.asarray(rng.normal(size=dof) * scale)))


_WRAP = {"se2": (JSE2, SE2), "se3": (JSE3, SE3), "sim3": (JSim3, Sim3)}


def _imu_pim(pkg):
    """A preintegrated interval from the same seeded samples in either package."""
    rng = np.random.default_rng(5)
    omega, accel = rng.normal(0, 0.3, (40, 3)), rng.normal(0, 1.0, (40, 3)) + [0.0, 0.0, 9.81]
    dts, bg, ba = np.full(40, 0.005), np.array([0.002, -0.001, 0.003]), np.array([0.05, -0.03, 0.02])
    if pkg == "jax":
        return jimu.preintegrate(jnp.asarray(omega), jnp.asarray(accel), jnp.asarray(dts), jnp.asarray(bg),
                                 jnp.asarray(ba))
    return timu.preintegrate(torch.tensor(omega), torch.tensor(accel), torch.tensor(dts), torch.tensor(bg),
                             torch.tensor(ba), device="cpu")


def _case(name, rng):
    """(jax residual, torch residual, numpy parameters, reference wrappers,
    port wrappers) of one case: the same numpy inputs to both packages."""
    if name == "quadratic":
        x, y, s = rng.normal(size=3)
        return JR.QuadraticResidual(x, y, s), TR.QuadraticResidual(x, y, s), [rng.normal(size=3)], [None], [None]
    if name.startswith(("prior_", "between_")):
        kind = name.split("_")[1]
        jw, tw = _WRAP[kind]
        dof = {"se2": 3, "se3": 6, "sim3": 7}[kind]
        stiff = np.diag(rng.uniform(0.5, 2.0, dof))
        T_obs = _pose(kind, rng, 0.3)
        if name.startswith("prior_"):
            return (JR.PoseResidual(jw(jnp.asarray(T_obs)), jnp.asarray(stiff)), TR.PoseResidual(tw(T_obs), stiff),
                    [_pose(kind, rng)], [jw], [tw])
        return (JR.PoseToPoseResidual(jw(jnp.asarray(T_obs)), jnp.asarray(stiff)),
                TR.PoseToPoseResidual(tw(T_obs), stiff), [_pose(kind, rng), _pose(kind, rng)], [jw, jw], [tw, tw])
    if name.startswith("switch_"):
        kind = name.split("_")[1]
        jw, tw = _WRAP[kind]
        stiff = rng.uniform(0.5, 2.0)
        T_obs = _pose(kind, rng, 0.3)
        params = [_pose(kind, rng), _pose(kind, rng), np.array([0.7])]
        return (JR.PoseToPoseSwitchableResidual(jnp.asarray(T_obs), stiff, xi=3.0),
                TR.PoseToPoseSwitchableResidual(T_obs, stiff, xi=3.0), params, [jw, jw, None], [tw, tw, None])
    if name.startswith("reprojection_"):
        jcam, tcam = (JStereo(**CAM), StereoCamera(**CAM)) if name.endswith("stereo") else (JRGBD(**RGBD),
                                                                                             RGBDCamera(**RGBD))
        T = _pose("se3", rng, 0.2)
        pt = np.array([0.5, -0.3, 4.0]) + rng.normal(0, 0.2, 3)
        obs = np.array([300.0, 250.0, 30.0]) + rng.normal(0, 2.0, 3)
        stiff = np.diag(rng.uniform(0.5, 2.0, 3))
        return (JR.ReprojectionResidual(jcam, jnp.asarray(obs), jnp.asarray(stiff)),
                TR.ReprojectionResidual(tcam, obs, stiff), [T, pt], [JSE3, None], [SE3, None])
    if name in ("landmark_xy", "bearing_range"):
        T, lm = _pose("se2", rng), rng.normal(0, 3.0, 2)
        obs, stiff = rng.normal(0, 1.0, 2), np.diag(rng.uniform(0.5, 2.0, 2))
        jc, tc = ((JR.LandmarkXYResidual, TR.LandmarkXYResidual) if name == "landmark_xy"
                  else (JR.BearingRangeResidual, TR.BearingRangeResidual))
        return jc(jnp.asarray(obs), jnp.asarray(stiff)), tc(obs, stiff), [T, lm], [JSE2, None], [SE2, None]
    if name == "motion_only":
        T = _pose("se3", rng, 0.2)
        pts = np.stack([rng.uniform(-2, 2, 5), rng.uniform(-1, 1, 5), rng.uniform(2, 8, 5)], -1)
        obs = rng.normal(300.0, 40.0, (5, 3))
        return (JR.ReprojectionMotionOnlyBatchResidual(JStereo(**CAM), jnp.asarray(obs), jnp.asarray(pts), 1.5),
                TR.ReprojectionMotionOnlyBatchResidual(StereoCamera(**CAM), obs, pts, 1.5), [T], [JSE3], [SE3])
    if name == "imu":
        params = [_pose("se3", rng, 0.1), _pose("se3", rng, 0.1), rng.normal(0, 0.5, 3), rng.normal(0, 0.5, 3),
                  rng.normal(0, 0.01, 6)]
        return (JR.ImuResidual(_imu_pim("jax")), TR.ImuResidual(_imu_pim("torch")), params,
                [JSE3, JSE3, None, None, None], [SE3, SE3, None, None, None])
    if name == "dense_prior":
        kinds = ("se2", "euclidean")
        data = {"A": rng.normal(size=(5, 5)), "c": rng.normal(size=5), "x0_0": _pose("se2", rng),
                "x0_1": rng.normal(size=2)}
        jr = JR.DensePriorResidual(j_prior_kernel(kinds), kinds, {k: jnp.asarray(v) for k, v in data.items()})
        return jr, TR.DensePriorResidual(t_prior_kernel(kinds), kinds, data), [_pose("se2", rng), rng.normal(size=2)], \
            [JSE2, None], [SE2, None]
    raise KeyError(name)


CASES = ["quadratic", "prior_se2", "prior_se3", "prior_sim3", "between_se2", "between_se3", "between_sim3",
         "switch_se2", "switch_se3", "reprojection_stereo", "reprojection_rgbd", "landmark_xy", "bearing_range",
         "motion_only", "imu", "dense_prior"]


@pytest.mark.parametrize("name", CASES)
def test_evaluate_matches_reference(name):
    rng = np.random.default_rng(CASES.index(name))
    jr, tr, params, jw, tw = _case(name, rng)
    assert (tr.factor_kind, tuple(tr.param_kinds)) == (jr.factor_kind, tuple(jr.param_kinds))
    jp = [w(jnp.asarray(p)) if w else jnp.asarray(p) for p, w in zip(params, jw)]
    tp = [w(torch.tensor(p)) if w else torch.tensor(p) for p, w in zip(params, tw)]
    flags = [True] * len(params)
    r_j, jac_j = jr.evaluate(jp, compute_jacobians=flags)
    r_t, jac_t = tr.evaluate(tp, compute_jacobians=flags)
    _close(r_t, r_j)
    for a, b in zip(jac_t, jac_j):
        _close(a, b)
    _close(tr.evaluate(tp), jr.evaluate(jp))


@pytest.mark.parametrize("name", ["prior_se3", "between_se2", "between_sim3", "reprojection_stereo", "motion_only",
                                  "bearing_range", "imu"])
def test_jacobians_match_autodiff_of_evaluate(name):
    """Each analytic Jacobian against ``torch.func.jacfwd`` of ``evaluate``
    through the slot's retraction (``tests/test_residuals.py``'s check)."""
    from pyslam_tpu_torch.graph.core import retract

    _, tr, params, _, tw = _case(name, np.random.default_rng(100 + len(name)))
    tp = [torch.tensor(p) for p in params]
    _, jacs = tr.evaluate([w(p) if w else p for p, w in zip(tp, tw)], compute_jacobians=[True] * len(tp))
    for i, kind in enumerate(tr.param_kinds):
        def f(eps, i=i, kind=kind):
            vals = list(tp)
            vals[i] = retract(kind, tp[i][None], eps[None])[0]
            return tr.evaluate(vals)

        dof = jacs[i].shape[-1]
        _close(jacs[i], torch.func.jacfwd(f)(torch.zeros(dof, dtype=torch.float64)), 1e-9)


def test_zero_at_observation_and_at_consistent_poses():
    rng = np.random.default_rng(3)
    T_obs = _pose("se3", rng, 1.0)
    assert torch.allclose(TR.PoseResidual(SE3(T_obs), 1.0).evaluate([SE3(T_obs)]), torch.zeros(6, dtype=torch.float64),
                          atol=1e-12)
    T1, T2 = _pose("se3", rng, 1.0), _pose("se3", rng, 1.0)
    r = TR.PoseToPoseResidual(SE3(T2 @ np.linalg.inv(T1)), 1.0).evaluate([SE3(T1), SE3(T2)])
    assert r.abs().max().item() < 1e-12


def test_selective_jacobians_and_quadratic_values():
    jr, tr, params, _, tw = _case("reprojection_stereo", np.random.default_rng(4))
    r, jacs = tr.evaluate([SE3(torch.tensor(params[0])), torch.tensor(params[1])], compute_jacobians=[False, True])
    assert jacs[0] is None and jacs[1] is not None and r.shape == (3,)
    res = TR.QuadraticResidual(2.0, 9.0, 3.0)
    r, (J,) = res.evaluate([torch.tensor([1.0, 2.0, 1.0], dtype=torch.float64)], compute_jacobians=[True])
    assert r.abs().max().item() < 1e-12
    _close(J, [[12.0, 6.0, 3.0]])


def test_measurements_stay_on_the_host():
    """A residual made from tensors keeps numpy copies: Problem stacks
    them on the host and copies each batch to the device once."""
    res = TR.PoseToPoseResidual(SE2(torch.eye(3, dtype=torch.float64)), torch.tensor(2.0, dtype=torch.float64))
    assert all(isinstance(v, np.ndarray) for v in res.batch_data().values())
    assert TR.ImuResidual(_imu_pim("torch")).batch_data()["dR"].dtype == np.float64
