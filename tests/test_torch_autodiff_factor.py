"""The open half of the factor registry of the torch port
(``graph/core.py``: ``register_autodiff_factor``, ``check_autodiff_factor``,
``register_closed_kernel``) against the analytic kernels and the JAX
reference, in f64 on the CPU (the cases of
``tests/test_autodiff_factor.py``).

Tolerances: the clones' residuals and Jacobians within 1e-12 of the
analytic kernels and of the reference's autodiff clones (relative to the
largest entry, absolute below 1), also at the identity, where every
retraction takes its small-angle branch; a solve through an autodiff
factor within 1e-8 of the same solve through the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.graph import FactorBatch as JFB
from pyslam_tpu.graph import FactorGraph as JFG
from pyslam_tpu.graph import VariableBlock as JVB
from pyslam_tpu.graph import register_autodiff_factor as jregister
from pyslam_tpu.graph.core import FACTOR_KERNELS as JK
from pyslam_tpu.graph.core import register_closed_kernel as jclosed
from pyslam_tpu.lie import se2 as jse2, se3 as jse3, sim3 as jsim3
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu.sensors import StereoCamera as JStereo
from pyslam_tpu.solver import Options as JOptions
from pyslam_tpu.solver import solve as jsolve
from pyslam_tpu_torch.graph import (
    FACTOR_KERNELS,
    FactorBatch,
    FactorGraph,
    VariableBlock,
    check_autodiff_factor,
    register_autodiff_factor,
    register_closed_kernel,
)
from pyslam_tpu_torch.io import synth
from pyslam_tpu_torch.lie import se2, se3, sim3
from pyslam_tpu_torch.losses import L2Loss
from pyslam_tpu_torch.sensors import StereoCamera
from pyslam_tpu_torch.solver import Options, solve
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

TOL = 1e-12
OPS = {"se2": (se2, jse2, 3), "se3": (se3, jse3, 6), "sim3": (sim3, jsim3, 7)}


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    out = out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1.0))


def _between(ops):
    def residual(data, T1, T2):
        r = ops.log(T2 @ ops.inv(T1) @ ops.inv(data["T_obs"]))
        return (data["sqrt_info"] @ r[..., None])[..., 0]

    return residual


def _prior(ops):
    def residual(data, T):
        return (data["sqrt_info"] @ ops.log(T @ ops.inv(data["T_obs"]))[..., None])[..., 0]

    return residual


def _jax_between(ops):
    def residual(data, T1, T2):
        return jnp.einsum("...ij,...j->...i", data["sqrt_info"], ops.log(T2 @ ops.inv(T1) @ ops.inv(data["T_obs"])))

    return residual


def _jax_prior(ops):
    def residual(data, T):
        return jnp.einsum("...ij,...j->...i", data["sqrt_info"], ops.log(T @ ops.inv(data["T_obs"])))

    return residual


for _kind, (_t, _j, _) in OPS.items():
    register_autodiff_factor(f"between_{_kind}_ad", _between(_t), (_kind, _kind))
    register_autodiff_factor(f"prior_{_kind}_ad", _prior(_t), (_kind,))
    jregister(f"between_{_kind}_ad", _jax_between(_j), (_kind, _kind))
    jregister(f"prior_{_kind}_ad", _jax_prior(_j), (_kind,))


def _inputs(kind, n, rng, identity=False):
    """Numpy poses and data of one batch: random, or all at the identity
    with an identity measurement (every retraction at eps = 0 and every
    log at the identity)."""
    _, jops, dof = OPS[kind]
    if identity:
        eye = np.broadcast_to(np.eye(4 if kind != "se2" else 3), (n,) + ((3, 3) if kind == "se2" else (4, 4))).copy()
        return eye, eye.copy(), {"T_obs": eye.copy(), "sqrt_info": np.broadcast_to(np.eye(dof), (n, dof, dof)).copy()}
    exp = lambda s: np.asarray(jops.exp(jnp.asarray(rng.normal(size=(n, dof)) * s)))  # noqa: E731
    sqrt_info = np.linalg.cholesky(np.eye(dof) * 2.0 + 0.3 * np.ones((dof, dof)))
    return exp(0.4), exp(0.4), {"T_obs": exp(0.2), "sqrt_info": np.broadcast_to(sqrt_info, (n, dof, dof)).copy()}


@pytest.mark.parametrize("identity", [False, True])
@pytest.mark.parametrize("kind", sorted(OPS))
@pytest.mark.parametrize("arity", ["between", "prior"])
def test_clone_matches_analytic_and_reference(arity, kind, identity):
    rng = np.random.default_rng(7)
    T1, T2, data = _inputs(kind, 5, rng, identity)
    vals = (T1, T2) if arity == "between" else (T1,)
    tdata = {k: torch.tensor(v) for k, v in data.items()}
    tvals = [torch.tensor(v) for v in vals]
    r_a, jac_a = FACTOR_KERNELS[f"{arity}_{kind}"](tdata, *tvals)
    r_d, jac_d = FACTOR_KERNELS[f"{arity}_{kind}_ad"](tdata, *tvals)
    r_j, jac_j = jax.jit(JK[f"{arity}_{kind}_ad"])({k: jnp.asarray(v) for k, v in data.items()}, *map(jnp.asarray, vals))
    _close(r_d, r_a)
    _close(r_d, r_j)
    assert len(jac_d) == len(vals)
    for Ja, Jd, Jj in zip(jac_a, jac_d, jac_j):
        assert torch.isfinite(Jd).all()
        _close(Jd, Ja)
        _close(Jd, Jj)
    check_autodiff_factor(f"{arity}_{kind}_ad", tdata, *tvals)


def test_rejects_row_coupled_residual():
    def coupled(data, x):
        r = x - data["obs"]
        return r / r.std()  # a batch statistic couples the rows

    register_autodiff_factor("coupled_demo", coupled, ("euclidean",))
    rng = np.random.default_rng(1)
    with pytest.raises(ValueError, match="coupled"):
        check_autodiff_factor("coupled_demo", {"obs": torch.tensor(rng.normal(size=(6, 3)))},
                              torch.tensor(rng.normal(size=(6, 3))))


def _range_graph(pkg):
    """Six frozen sphere poses observe four beacons with exact ranges
    (``tests/test_autodiff_factor.py``'s multilateration), in either
    package."""
    data = synth.se3_sphere(n_poses=6, n_loops=3, seed=2)
    beacons = np.random.default_rng(3).normal(0, 5, (4, 3))
    pi, bi = (a.ravel() for a in np.meshgrid(np.arange(6), np.arange(4)))
    d_obs = np.linalg.norm(beacons[bi] - data.T_gt[pi, :3, 3], axis=-1)
    if pkg == "jax":
        blocks = {"poses": JVB.create("se3", jnp.asarray(data.T_gt), np.ones(6, bool)),
                  "beacons": JVB.create("euclidean", jnp.asarray(beacons + 0.5))}
        batch = JFB.create("range3d", slots=("poses", "beacons"), indices=(pi.astype(np.int32), bi.astype(np.int32)),
                           data={"d_obs": jnp.asarray(d_obs), "w": jnp.full(len(pi), 10.0)}, loss=JL2())
        return JFG(blocks, [batch]), beacons
    blocks = {"poses": VariableBlock.create("se3", torch.tensor(data.T_gt), np.ones(6, bool)),
              "beacons": VariableBlock.create("euclidean", torch.tensor(beacons + 0.5))}
    batch = FactorBatch.create("range3d", slots=("poses", "beacons"), indices=(pi, bi),
                               data={"d_obs": torch.tensor(d_obs), "w": torch.full((len(pi),), 10.0,
                                                                                     dtype=torch.float64)},
                               loss=L2Loss())
    return FactorGraph(blocks, [batch]), beacons


def test_custom_factor_solves_as_the_reference():
    def range_residual(data, T, beacon):
        d = torch.linalg.norm(beacon - T[..., :3, 3], dim=-1, keepdim=True)
        return data["w"][:, None] * (d - data["d_obs"][:, None])

    def jax_range(data, T, beacon):
        d = jnp.linalg.norm(beacon - T[..., :3, 3], axis=-1, keepdims=True)
        return data["w"][:, None] * (d - data["d_obs"][:, None])

    register_autodiff_factor("range3d", range_residual, ("se3", "euclidean"))
    jregister("range3d", jax_range, ("se3", "euclidean"))
    opts = dict(method="lm", max_iters=200, min_cost_decrease=0.999999)
    tg, beacons = _range_graph("torch")
    jg, _ = _range_graph("jax")
    ts, ti = solve(tg, Options(**opts))
    js, ji = jsolve(jg, JOptions(**opts))
    assert float(ti.chi2) < 1e-12 and ti.iterations == ji.iterations
    _close(ts.blocks["beacons"].values, js.blocks["beacons"].values, 1e-8)
    assert np.abs(ts.blocks["beacons"].values.numpy() - beacons).max() < 1e-6


def test_closed_kernel_names_follow_content():
    cam = dict(cu=320.0, cv=240.0, fu=500.0, fv=480.0, b=0.25, w=640, h=480)
    a = register_closed_kernel("reprojection", {"camera": StereoCamera(**cam)})
    assert a == register_closed_kernel("reprojection", {"camera": StereoCamera(**cam)})
    assert a != register_closed_kernel("reprojection", {"camera": StereoCamera(**{**cam, "fu": 501.0})})
    s = torch.eye(3, dtype=torch.float64)
    b = register_closed_kernel("prior_euclidean", {"sqrt_info": s})
    assert b == register_closed_kernel("prior_euclidean", {"sqrt_info": s.clone()}) != a
    assert b != register_closed_kernel("prior_euclidean", {"sqrt_info": s.float()})
    assert jclosed("prior_euclidean", {"sqrt_info": jnp.eye(3)}).startswith("__closed_prior_euclidean_")
    # the closed kernel evaluates as the kernel with the data merged in
    rng = np.random.default_rng(4)
    x, obs = torch.tensor(rng.normal(size=(5, 3))), torch.tensor(rng.normal(size=(5, 3)))
    r_c, (J_c,) = FACTOR_KERNELS[b]({"obs": obs}, x)
    r, (J,) = FACTOR_KERNELS["prior_euclidean"]({"obs": obs, "sqrt_info": s}, x)
    assert torch.equal(r_c, r) and torch.equal(J_c, J)
    assert JStereo(**cam).fu == StereoCamera(**cam).fu
