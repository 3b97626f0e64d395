"""SO(2) / SE(2) / Sim(3) of the torch port against the JAX reference, in
f64 on the CPU, on the same numpy inputs: small angles (the Taylor
branches), generic angles, angles within 1e-4 of pi, and for Sim(3) also
small log-scales, small rotations with large scale, and both small (each
branch of ``_W_coeffs``).

Tolerance: 1e-12 absolute; 1e-9 on the near-pi and small-sigma inputs,
where the closed forms go through ratios of nearly cancelling terms and
both libraries' transcendental functions round differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.lie import se2 as jse2
from pyslam_tpu.lie import se3 as jse3
from pyslam_tpu.lie import sim3 as jsim3
from pyslam_tpu.lie import so2 as jso2
from pyslam_tpu_torch.lie import se2 as tse2
from pyslam_tpu_torch.lie import sim3 as tsim3
from pyslam_tpu_torch.lie import so2 as tso2
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

N = 16
TOL = {
    "small": 1e-12,
    "generic": 1e-12,
    "near_pi": 1e-9,
    "small_sigma": 1e-9,
    "small_theta": 1e-12,
    "both_small": 1e-12,
}


def _angle(regime, seed=0):
    rng = np.random.default_rng(seed)
    if regime == "small":
        a = rng.uniform(-5e-5, 5e-5, N)
        a[0] = 0.0
    elif regime == "generic":
        a = rng.uniform(-3.0, 3.0, N)
    else:
        a = (np.pi - rng.uniform(1e-7, 1e-4, N)) * rng.choice([-1.0, 1.0], N)
    return a


def _xi2(regime, seed=0):
    rng = np.random.default_rng(seed + 100)
    return np.concatenate([rng.normal(size=(N, 2)), _angle(regime, seed)[:, None]], axis=1)


def _pts(dim, seed=0):
    return np.random.default_rng(seed + 200).normal(size=(N, dim))


def _cmp(jax_out, torch_out, tol):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def _run(cases, name, regime):
    jf, tf, make = cases[name]
    args = make(regime)
    out_j = jf(*[jnp.asarray(a) for a in args])
    out_t = tf(*[torch.from_numpy(np.array(a, copy=True)) for a in args])
    _cmp(out_j, out_t, TOL[regime])


def _T2(regime, seed=0):
    return np.asarray(jse2.exp(jnp.asarray(_xi2(regime, seed))))


SO2_CASES = {
    "wedge": (jso2.wedge, tso2.wedge, lambda r: [_angle(r)]),
    "wedge_trailing_axis": (jso2.wedge, tso2.wedge, lambda r: [_angle(r)[:, None]]),
    "vee": (jso2.vee, tso2.vee, lambda r: [np.asarray(jso2.wedge(jnp.asarray(_angle(r))))]),
    "exp": (jso2.exp, tso2.exp, lambda r: [_angle(r)]),
    "log": (jso2.log, tso2.log, lambda r: [np.asarray(jso2.exp(jnp.asarray(_angle(r))))]),
    "inv": (jso2.inv, tso2.inv, lambda r: [np.asarray(jso2.exp(jnp.asarray(_angle(r))))]),
    "mul": (
        jso2.mul,
        tso2.mul,
        lambda r: [np.asarray(jso2.exp(jnp.asarray(_angle(r)))), np.asarray(jso2.exp(jnp.asarray(_angle(r, 1))))],
    ),
    "act": (jso2.act, tso2.act, lambda r: [np.asarray(jso2.exp(jnp.asarray(_angle(r)))), _pts(2)]),
    "perturb": (
        jso2.perturb,
        tso2.perturb,
        lambda r: [np.asarray(jso2.exp(jnp.asarray(_angle("generic", 3)))), _angle(r)],
    ),
}

SE2_CASES = {
    "wedge": (jse2.wedge, tse2.wedge, lambda r: [_xi2(r)]),
    "vee": (jse2.vee, tse2.vee, lambda r: [np.asarray(jse2.wedge(jnp.asarray(_xi2(r))))]),
    "exp": (jse2.exp, tse2.exp, lambda r: [_xi2(r)]),
    "exp_batch_of_one": (jse2.exp, tse2.exp, lambda r: [_xi2(r)[:1]]),
    "log": (jse2.log, tse2.log, lambda r: [_T2(r)]),
    "inv": (jse2.inv, tse2.inv, lambda r: [_T2(r)]),
    "mul": (jse2.mul, tse2.mul, lambda r: [_T2(r), _T2(r, 1)]),
    "act": (jse2.act, tse2.act, lambda r: [_T2(r), _pts(2)]),
    "adjoint": (jse2.adjoint, tse2.adjoint, lambda r: [_T2(r)]),
    "odot": (jse2.odot, tse2.odot, lambda r: [_pts(2)]),
    "left_jacobian": (jse2.left_jacobian, tse2.left_jacobian, lambda r: [_xi2(r)]),
    "inv_left_jacobian": (jse2.inv_left_jacobian, tse2.inv_left_jacobian, lambda r: [_xi2(r)]),
    "perturb": (jse2.perturb, tse2.perturb, lambda r: [_T2("generic", 3), _xi2(r)]),
}

SIM3_REGIMES = ["generic", "small_theta", "small_sigma", "both_small", "near_pi"]


def _xi7(regime, seed=0):
    """[rho, phi, sigma] in one of the four (sigma small?) x (theta small?)
    regions of ``_W_coeffs``, or with theta near pi."""
    rng = np.random.default_rng(seed + 300)
    axis = rng.normal(size=(N, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    small_t = regime in ("small_theta", "both_small")
    small_s = regime in ("small_sigma", "both_small")
    if small_t:
        theta = rng.uniform(0.0, 8e-4, N)
        theta[0] = 0.0
    elif regime == "near_pi":
        theta = np.pi - rng.uniform(1e-7, 1e-4, N)
    else:
        theta = rng.uniform(0.1, 3.0, N)
    sigma = rng.uniform(-8e-4, 8e-4, N) if small_s else rng.uniform(-0.5, 0.5, N) + 0.01
    if small_s:
        sigma[1] = 0.0
    return np.concatenate([rng.normal(size=(N, 3)), axis * theta[:, None], sigma[:, None]], axis=1)


def _S(regime, seed=0):
    return np.asarray(jsim3.exp(jnp.asarray(_xi7(regime, seed))))


def _T3(seed=0):
    rng = np.random.default_rng(seed + 400)
    return np.asarray(jse3.exp(jnp.asarray(rng.normal(size=(N, 6)))))


SIM3_CASES = {
    "wedge": (jsim3.wedge, tsim3.wedge, lambda r: [_xi7(r)]),
    "vee": (jsim3.vee, tsim3.vee, lambda r: [np.asarray(jsim3.wedge(jnp.asarray(_xi7(r))))]),
    "W": (jsim3._W, tsim3._W, lambda r: [_xi7(r)[:, 6], _xi7(r)[:, 3:6]]),
    "inv3": (jsim3._inv3, tsim3._inv3, lambda r: [np.asarray(jsim3._W(*map(jnp.asarray, (_xi7(r)[:, 6], _xi7(r)[:, 3:6]))))]),
    "exp": (jsim3.exp, tsim3.exp, lambda r: [_xi7(r)]),
    "log": (jsim3.log, tsim3.log, lambda r: [_S(r)]),
    "scale": (jsim3.scale, tsim3.scale, lambda r: [_S(r)]),
    "rot": (jsim3.rot, tsim3.rot, lambda r: [_S(r)]),
    "trans": (jsim3.trans, tsim3.trans, lambda r: [_S(r)]),
    "inv": (jsim3.inv, tsim3.inv, lambda r: [_S(r)]),
    "mul": (jsim3.mul, tsim3.mul, lambda r: [_S(r), _S(r, 1)]),
    "act": (jsim3.act, tsim3.act, lambda r: [_S(r), _pts(3)]),
    "adjoint": (jsim3.adjoint, tsim3.adjoint, lambda r: [_S(r)]),
    "ad": (jsim3._ad, tsim3._ad, lambda r: [_xi7(r)]),
    "left_jacobian": (jsim3.left_jacobian, tsim3.left_jacobian, lambda r: [_xi7(r)]),
    "inv_left_jacobian": (jsim3.inv_left_jacobian, tsim3.inv_left_jacobian, lambda r: [_xi7(r)]),
    "perturb": (jsim3.perturb, tsim3.perturb, lambda r: [_S("generic", 3), _xi7(r)]),
    "normalize": (
        jsim3.normalize,
        tsim3.normalize,
        lambda r: [_S(r) + 1e-6 * np.random.default_rng(5).normal(size=(N, 4, 4)) * np.array([1, 1, 1, 0])[:, None]],
    ),
    "to_se3": (jsim3.to_se3, tsim3.to_se3, lambda r: [_S(r)]),
}


@pytest.mark.parametrize("regime", ["small", "generic", "near_pi"])
@pytest.mark.parametrize("name", sorted(SO2_CASES))
def test_so2_matches_reference(name, regime):
    _run(SO2_CASES, name, regime)


@pytest.mark.parametrize("regime", ["small", "generic", "near_pi"])
@pytest.mark.parametrize("name", sorted(SE2_CASES))
def test_se2_matches_reference(name, regime):
    _run(SE2_CASES, name, regime)


@pytest.mark.parametrize("regime", SIM3_REGIMES)
@pytest.mark.parametrize("name", sorted(SIM3_CASES))
def test_sim3_matches_reference(name, regime):
    _run(SIM3_CASES, name, regime)


@pytest.mark.parametrize("s", [1.0, 2.5])
def test_sim3_from_se3(s):
    T = _T3()
    _cmp(jsim3.from_se3(jnp.asarray(T), s), tsim3.from_se3(torch.from_numpy(T.copy()), s), 1e-12)


@pytest.mark.parametrize("regime", SIM3_REGIMES)
def test_sim3_exp_log_roundtrip(regime):
    """log(exp(xi)) == xi in the port itself, every branch of W included."""
    xi = torch.from_numpy(_xi7(regime))
    np.testing.assert_allclose(tsim3.log(tsim3.exp(xi)).numpy(), xi.numpy(), rtol=0, atol=TOL[regime] * 100)


def test_sim3_unselected_branches_stay_finite():
    """At sigma = 0 and theta = 0 every branch of ``_W_coeffs`` is still
    evaluated; the guards keep each finite, so no NaN reaches the result or
    its gradient."""
    xi = torch.zeros(1, 7, dtype=torch.float64, requires_grad=True)
    S = tsim3.exp(xi)
    S.sum().backward()
    assert torch.isfinite(S).all() and torch.isfinite(xi.grad).all()
    np.testing.assert_allclose(S.detach().numpy()[0], np.eye(4), rtol=0, atol=1e-15)


@pytest.mark.parametrize("module", ["so2", "se2", "sim3"])
def test_identity(module):
    jm, tm = {"so2": (jso2, tso2), "se2": (jse2, tse2), "sim3": (jsim3, tsim3)}[module]
    _cmp(jm.identity(jnp.float64, (2, 3)), tm.identity(torch.float64, (2, 3), device="cpu"), 0.0)
