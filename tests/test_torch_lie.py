"""SO(3) / SE(3) of the torch port against the JAX reference, in f64 on the
CPU, on the same numpy inputs: small angles (the Taylor branches), generic
angles, and angles within 1e-4 of pi (the log's near-pi branch).

Tolerance: 1e-12 absolute; 1e-9 on the near-pi inputs, where the log's
axis recovery goes through a square root of (1 - cos) terms and both
libraries' transcendental functions round differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.lie import se3 as jse3
from pyslam_tpu.lie import so3 as jso3
from pyslam_tpu_torch.lie import se3 as tse3
from pyslam_tpu_torch.lie import so3 as tso3

REGIMES = ["small", "generic", "near_pi"]
TOL = {"small": 1e-12, "generic": 1e-12, "near_pi": 1e-9}
N = 16


def _phi(regime, seed=0):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(N, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    if regime == "small":
        theta = rng.uniform(1e-9, 5e-5, N)
        theta[0] = 0.0
    elif regime == "generic":
        theta = rng.uniform(0.1, 3.0, N)
    else:
        theta = np.pi - rng.uniform(1e-7, 1e-4, N)
    return axis * theta[:, None]


def _xi(regime, seed=0):
    rng = np.random.default_rng(seed + 100)
    return np.concatenate([rng.normal(size=(N, 3)), _phi(regime, seed)], axis=1)


def _pts(seed=0):
    return np.random.default_rng(seed + 200).normal(size=(N, 3))


def _cmp(jax_out, torch_out, tol):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x, copy=True))


# name -> (jax fn, torch fn, input builders given regime)
SO3_CASES = {
    "wedge": (jso3.wedge, tso3.wedge, lambda r: [_phi(r)]),
    "exp": (jso3.exp, tso3.exp, lambda r: [_phi(r)]),
    "log": (jso3.log, tso3.log, lambda r: [np.asarray(jso3.exp(jnp.asarray(_phi(r))))]),
    "vee": (jso3.vee, tso3.vee, lambda r: [np.asarray(jso3.wedge(jnp.asarray(_phi(r))))]),
    "left_jacobian": (jso3.left_jacobian, tso3.left_jacobian, lambda r: [_phi(r)]),
    "inv_left_jacobian": (jso3.inv_left_jacobian, tso3.inv_left_jacobian, lambda r: [_phi(r)]),
    "inv": (jso3.inv, tso3.inv, lambda r: [np.asarray(jso3.exp(jnp.asarray(_phi(r))))]),
    "mul": (
        jso3.mul,
        tso3.mul,
        lambda r: [np.asarray(jso3.exp(jnp.asarray(_phi(r)))), np.asarray(jso3.exp(jnp.asarray(_phi(r, 1))))],
    ),
    "act": (jso3.act, tso3.act, lambda r: [np.asarray(jso3.exp(jnp.asarray(_phi(r)))), _pts()]),
    "perturb": (
        jso3.perturb,
        tso3.perturb,
        lambda r: [np.asarray(jso3.exp(jnp.asarray(_phi("generic", 3)))), _phi(r)],
    ),
}

SE3_CASES = {
    "wedge": (jse3.wedge, tse3.wedge, lambda r: [_xi(r)]),
    "vee": (jse3.vee, tse3.vee, lambda r: [np.asarray(jse3.wedge(jnp.asarray(_xi(r))))]),
    "curlywedge": (jse3.curlywedge, tse3.curlywedge, lambda r: [_xi(r)]),
    "exp": (jse3.exp, tse3.exp, lambda r: [_xi(r)]),
    "log": (jse3.log, tse3.log, lambda r: [np.asarray(jse3.exp(jnp.asarray(_xi(r))))]),
    "inv": (jse3.inv, tse3.inv, lambda r: [np.asarray(jse3.exp(jnp.asarray(_xi(r))))]),
    "mul": (
        jse3.mul,
        tse3.mul,
        lambda r: [np.asarray(jse3.exp(jnp.asarray(_xi(r)))), np.asarray(jse3.exp(jnp.asarray(_xi(r, 1))))],
    ),
    "act": (jse3.act, tse3.act, lambda r: [np.asarray(jse3.exp(jnp.asarray(_xi(r)))), _pts()]),
    "adjoint": (jse3.adjoint, tse3.adjoint, lambda r: [np.asarray(jse3.exp(jnp.asarray(_xi(r))))]),
    "odot": (jse3.odot, tse3.odot, lambda r: [_pts()]),
    "odot_directional": (
        lambda p: jse3.odot(p, directional=True),
        lambda p: tse3.odot(p, directional=True),
        lambda r: [_pts()],
    ),
    "Q_matrix": (
        jse3._Q_matrix,
        tse3._Q_matrix,
        lambda r: [_xi(r)[:, :3], _xi(r)[:, 3:]],
    ),
    "left_jacobian": (jse3.left_jacobian, tse3.left_jacobian, lambda r: [_xi(r)]),
    "inv_left_jacobian": (jse3.inv_left_jacobian, tse3.inv_left_jacobian, lambda r: [_xi(r)]),
    "perturb": (
        jse3.perturb,
        tse3.perturb,
        lambda r: [np.asarray(jse3.exp(jnp.asarray(_xi("generic", 3)))), _xi(r)],
    ),
    "normalize": (
        jse3.normalize,
        tse3.normalize,
        lambda r: [
            np.asarray(jse3.exp(jnp.asarray(_xi(r))))
            + 1e-6 * np.random.default_rng(5).normal(size=(N, 4, 4)) * np.array([1, 1, 1, 0])[:, None]
        ],
    ),
}


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("name", sorted(SO3_CASES))
def test_so3_matches_reference(name, regime):
    jf, tf, make = SO3_CASES[name]
    pairs = [_both(a) for a in make(regime)]
    _cmp(jf(*[p[0] for p in pairs]), tf(*[p[1] for p in pairs]), TOL[regime])


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("name", sorted(SE3_CASES))
def test_se3_matches_reference(name, regime):
    jf, tf, make = SE3_CASES[name]
    pairs = [_both(a) for a in make(regime)]
    _cmp(jf(*[p[0] for p in pairs]), tf(*[p[1] for p in pairs]), TOL[regime])


@pytest.mark.parametrize("regime", REGIMES)
def test_exp_log_roundtrip(regime):
    """log(exp(xi)) == xi in the port itself (the near-pi branch included)."""
    xi = torch.from_numpy(_xi(regime))
    np.testing.assert_allclose(tse3.log(tse3.exp(xi)).numpy(), xi.numpy(), rtol=0, atol=TOL[regime] * 10)


def test_log_near_pi_takes_first_argmax_on_ties():
    """A rotation by exactly pi about an axis with two equal components:
    argmax ties go to the first index in both frameworks."""
    axis = np.array([[1.0, 1.0, 0.0]]) / np.sqrt(2.0)
    R = np.asarray(jso3.exp(jnp.asarray(axis * np.pi)))
    _cmp(jso3.log(jnp.asarray(R)), tso3.log(torch.from_numpy(R.copy())), 1e-9)


@pytest.mark.parametrize("module", ["so3", "se3"])
def test_identity(module):
    jm, tm = (jso3, tso3) if module == "so3" else (jse3, tse3)
    _cmp(jm.identity(jnp.float64, (2, 3)), tm.identity(torch.float64, (2, 3)), 0.0)
