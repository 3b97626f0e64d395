"""Differentiable solving of the torch port (``solver/diff.py``,
``solve_implicit`` as a ``torch.autograd.Function``) against the JAX
reference's ``solve_implicit`` and against central differences, in f64 on
the CPU, on ``tests/test_diff.py``'s three graphs (se2_loop(10, 2, seed 0)
with its trajectory-plus-chi2 objective; se2_loop(8, 1, seed 2), chi2
alone; se2_loop(8, 1, seed 3) with its anchored pose) and on graphs where
a factor's error is exactly zero.

Tolerances: the gradient within 1e-8 of the reference's, relative to its
largest entry; against central differences (eps 1e-5) ``tests/test_diff.py``'s
atol 2e-3, rtol 1e-2.  The backward's segment sums run through
``cuda_ops.slot_reduce``'s autograd Function (the gather of
``slot_reduce_backward``), held here to autograd through the plain version
and to ``torch.autograd.gradcheck``, and so does ``assemble_dense`` with
its in-place masking.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorBatch as JFB
from pyslam_tpu.graph.core import FactorGraph as JFG
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import Options as JOptions
from pyslam_tpu.solver.diff import solve_implicit as jsolve_implicit
from pyslam_tpu_torch.graph import build
from pyslam_tpu_torch.graph.core import FactorBatch, FactorGraph
from pyslam_tpu_torch.io import synth
from pyslam_tpu_torch.losses import L2Loss
from pyslam_tpu_torch.solver import Options, assemble_dense, cuda_ops, solve_implicit
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

OPTS = dict(method="lm", max_iters=60, min_cost_decrease=1 - 1e-13, min_update_norm=1e-14)
REL = 1e-8

GRAPHS = {
    "objective": (dict(n_poses=10, n_loops=2, seed=0), "objective"),
    "chi2": (dict(n_poses=8, n_loops=1, seed=2), "chi2"),
    "anchored": (dict(n_poses=8, n_loops=1, seed=3), "objective"),
    "exact": (dict(n_poses=8, n_loops=1, seed=3), "objective"),  # noise-free: every error zero up to rounding
}


def _exact(data):
    """The loop with noise-free measurements, started at the truth."""
    T_meas = np.stack([data.T_gt[j] @ np.linalg.inv(data.T_gt[i]) for i, j in zip(data.edges_i, data.edges_j)])
    return dataclasses.replace(data, T_meas=T_meas, T_init=data.T_gt.copy())


def _value(values, chi2, what):
    if what == "chi2":
        return chi2
    return values["poses"][-1, :2, 2].sum() + 0.1 * chi2


def torch_objective(g, what):
    fb = g.batches[0]

    def objective(T_obs):
        fb2 = FactorBatch(fb.kind, fb.slots, fb.indices, {**fb.data, "T_obs": T_obs}, fb.loss, fb.weight)
        return _value(*solve_implicit(FactorGraph(g.blocks, [fb2, *g.batches[1:]]), Options(**OPTS)), what)

    return objective


def jax_objective(g, what):
    fb = g.batches[0]

    def objective(T_obs):
        fb2 = JFB(fb.kind, fb.slots, fb.indices, {**fb.data, "T_obs": T_obs}, fb.loss, fb.weight)
        values, chi2 = jsolve_implicit(JFG(g.blocks, [fb2]), JOptions(**OPTS))
        return chi2 if what == "chi2" else jnp.sum(values["poses"][-1, :2, 2]) + 0.1 * chi2

    return objective


def _graphs(name):
    kw, what = GRAPHS[name]
    make = (lambda s: _exact(s.se2_loop(**kw))) if name == "exact" else (lambda s: s.se2_loop(**kw))
    return (build.pose_graph(make(synth), dtype=torch.float64, device="cpu"),
            jbuild.pose_graph(make(jsynth), dtype=jnp.float64), what)


@pytest.fixture(scope="module")
def gradients():
    """Each graph's gradient in both packages, computed once."""
    out = {}
    for name in GRAPHS:
        tg, jg, what = _graphs(name)
        T = tg.batches[0].data["T_obs"].clone().requires_grad_()
        (grad,) = torch.autograd.grad(torch_objective(tg, what)(T), T)
        jgrad = np.asarray(jax.grad(jax_objective(jg, what))(jg.batches[0].data["T_obs"]))
        out[name] = (tg, what, grad, jgrad)
    return out


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gradient_matches_reference(gradients, name):
    _, _, grad, jgrad = gradients[name]
    assert torch.isfinite(grad).all() and np.abs(jgrad).max() > 0
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0, atol=REL * np.abs(jgrad).max())


@pytest.mark.parametrize("name,entries", [("objective", 5), ("chi2", 1)])
def test_gradient_matches_central_differences(gradients, name, entries):
    tg, what, grad, _ = gradients[name]
    objective = torch_objective(tg, what)
    T0 = tg.batches[0].data["T_obs"]
    rng = np.random.default_rng(1)
    eps = 1e-5
    picks = [(2, 0, 2)] if entries == 1 else [
        (int(rng.integers(0, T0.shape[0])), int(rng.integers(0, 2)), int(rng.integers(0, 3))) for _ in range(entries)]
    for e, i, j in picks:
        Tp, Tm = T0.clone(), T0.clone()
        Tp[e, i, j] += eps
        Tm[e, i, j] -= eps
        with torch.no_grad():
            fd = (objective(Tp).item() - objective(Tm).item()) / (2 * eps)
        np.testing.assert_allclose(grad[e, i, j].item(), fd, atol=2e-3, rtol=1e-2)


def test_anchored_pose_and_exact_factors_give_finite_gradients(gradients):
    for name in ("anchored", "exact"):
        grad = gradients[name][2]
        assert torch.isfinite(grad).all() and grad.norm() > 0


@pytest.mark.parametrize("kind", ["se2", "se3"])
def test_gradient_through_a_zero_error_factor_is_finite(kind):
    """The anchored pose moved to the identity and a prior on it whose
    measurement is the identity: its error is exactly zero at every
    iterate, so the backward goes through a log at the identity (the
    small-angle branches) and through the retractions at eps = 0."""
    from pyslam_tpu_torch.graph.core import VariableBlock

    data = synth.se2_loop(n_poses=8, n_loops=1, seed=3) if kind == "se2" else synth.se3_sphere(n_poses=8, n_loops=2,
                                                                                               seed=3)
    g = build.pose_graph(data, dtype=torch.float64, device="cpu")
    poses = g.blocks["poses"]
    n = poses.values.shape[-1]
    values = poses.values.clone()
    values[0] = torch.eye(n, dtype=torch.float64)
    g = FactorGraph({"poses": VariableBlock(poses.kind, values, poses.const_mask)}, g.batches)
    T0 = torch.eye(n, dtype=torch.float64)[None].requires_grad_()
    dof = 3 if kind == "se2" else 6
    prior = FactorBatch.create(f"prior_{kind}", ("poses",), (np.array([0]),),
                               {"T_obs": T0, "sqrt_info": torch.eye(dof, dtype=torch.float64)[None]}, L2Loss())
    graph = FactorGraph(g.blocks, [g.batches[0], prior])
    solved, chi2 = solve_implicit(graph, Options(**OPTS))
    assert torch.count_nonzero(prior.evaluate({"poses": VariableBlock(poses.kind, solved["poses"], poses.const_mask)},
                                              compute_jacobians=False)[0]) == 0
    (grad,) = torch.autograd.grad(solved["poses"][-1].sum() + 0.1 * chi2, [T0])
    assert torch.isfinite(grad).all()


def test_values_dict_and_chi2_match_a_plain_solve():
    from pyslam_tpu_torch.solver import solve

    g = build.pose_graph(synth.se2_loop(n_poses=8, n_loops=1, seed=2), dtype=torch.float64, device="cpu")
    values, chi2 = solve_implicit(g, Options(**OPTS))
    solved, info = solve(g, Options(**OPTS))
    assert list(values) == list(g.blocks) and torch.equal(values["poses"], solved.blocks["poses"].values)
    assert torch.equal(chi2, info.chi2)


def test_the_callers_values_stay_out_of_the_autograd_graph():
    """With no step taken the solved values are the graph's own; the
    outputs are copies, so the caller's tensor gets no grad_fn."""
    g = build.pose_graph(synth.se2_loop(n_poses=6, n_loops=1, seed=0), dtype=torch.float64, device="cpu")
    fb = g.batches[0]
    T = fb.data["T_obs"].clone().requires_grad_()
    fb2 = FactorBatch(fb.kind, fb.slots, fb.indices, {**fb.data, "T_obs": T}, fb.loss, fb.weight)
    values, _ = solve_implicit(FactorGraph(g.blocks, [fb2]), Options(max_iters=0))
    assert torch.equal(values["poses"], g.blocks["poses"].values) and values["poses"].grad_fn is not None
    assert g.blocks["poses"].values.grad_fn is None and not g.blocks["poses"].values.requires_grad


# --------------------------------------------------------------------------
# The differentiable segment sum
# --------------------------------------------------------------------------


def _plan(n_slots, E, C, seed):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, n_slots, E)
    sp = cuda_ops.slot_plan(dest, n_slots)
    contrib = torch.tensor(rng.normal(size=(E, C)))
    return contrib, torch.tensor(sp.perm), torch.tensor(sp.offsets), n_slots


@pytest.mark.parametrize("n_slots,E,C", [(7, 40, 6), (30, 25, 3), (5, 0, 4)])
def test_slot_reduce_backward_matches_plain_autograd(n_slots, E, C):
    contrib, perm, offsets, n = _plan(n_slots, E, C, n_slots)
    weights = torch.tensor(np.random.default_rng(9).normal(size=(n, C)))
    x = contrib.clone().requires_grad_()
    (g_fn,) = torch.autograd.grad((cuda_ops.slot_reduce(x, perm, offsets, n) * weights).sum(), x)
    x2 = contrib.clone().requires_grad_()
    (g_plain,) = torch.autograd.grad((cuda_ops.slot_reduce_plain(x2, perm, offsets, n) * weights).sum(), x2)
    assert torch.equal(g_fn, g_plain)
    assert torch.equal(cuda_ops.slot_reduce_backward(weights, perm, offsets), g_plain)
    if E:
        assert torch.autograd.gradcheck(lambda c: cuda_ops.slot_reduce(c, perm, offsets, n), (x,))


def test_slot_reduce_keeps_its_launch_path_without_grad():
    contrib, perm, offsets, n = _plan(7, 40, 6, 0)
    out = cuda_ops.slot_reduce(contrib.clone().requires_grad_(), perm, offsets, n)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_SlotReduceBackward"
    with torch.no_grad():
        assert cuda_ops.slot_reduce(contrib.clone().requires_grad_(), perm, offsets, n).grad_fn is None
    assert cuda_ops.slot_reduce(contrib, perm, offsets, n).grad_fn is None


def test_assemble_dense_is_differentiable_with_its_masks():
    """H, g and chi2 of the dense assembly (zeroed constant rows and unit
    diagonal written in place) against finite differences."""
    g = build.pose_graph(synth.se2_loop(n_poses=6, n_loops=1, seed=0), dtype=torch.float64, device="cpu")
    fb = g.batches[0]
    rng = np.random.default_rng(2)
    R, v = torch.tensor(rng.normal(size=(g.total_dof,) * 2)), torch.tensor(rng.normal(size=g.total_dof))

    def f(T_obs):
        fb2 = FactorBatch(fb.kind, fb.slots, fb.indices, {**fb.data, "T_obs": T_obs}, fb.loss, fb.weight)
        H, gvec, chi2 = assemble_dense(FactorGraph(g.blocks, [fb2]))
        return (H * R).sum() + (gvec * v).sum() + chi2

    assert torch.autograd.gradcheck(f, (fb.data["T_obs"].clone().requires_grad_(),))
