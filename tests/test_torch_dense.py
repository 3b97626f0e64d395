"""The dense LM path of the torch port against the JAX reference, in f64 on
the CPU, on the same problems carried across with ``graph_from_numpy``:
``se2_loop(n_poses=30, n_loops=4)``, ``sim3_loop(n_poses=40, n_loops=3)``,
``se2_manhattan(n_poses=200)`` and ``se3_sphere(n_poses=60, seed=11)``.

Tolerances:
  * factor residuals and Jacobians (``between_se2`` / ``between_sim3`` /
    priors) and manifold retractions: 1e-10 absolute;
  * ``assemble_dense`` H, g and chi2: 1e-10 relative to the largest entry
    (the port sums each entry in another order than XLA's scatter);
  * solves: the same iterations, stop codes and accept sequences, chi2 and
    the cost / lambda (trust radius) histories within 1e-8 relative, poses
    within 1e-6;
  * ``cholesky_solve`` / ``damp_marquardt`` / ``unit_diag_where_dead``:
    1e-10 relative; an indefinite H gives NaN.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import assert_rel, jax_graph, to_port

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph import core as jcore
from pyslam_tpu.graph.core import FactorBatch as JFactorBatch
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.graph.core import VariableBlock as JVariableBlock
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.losses import CauchyLoss as JCauchy
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu.solver import assemble as jas
from pyslam_tpu.solver import linear as jlin
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu_torch.graph import FactorGraph
from pyslam_tpu_torch.graph import build as tbuild
from pyslam_tpu_torch.graph import core as tcore
from pyslam_tpu_torch.io import synth as tsynth
from pyslam_tpu_torch.solver import assemble as tas
from pyslam_tpu_torch.solver import linear as tlin
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver.linear import HOST_READS, reset_host_reads
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64


def _se2(loss=None):
    return jbuild.pose_graph(jsynth.se2_loop(n_poses=30, n_loops=4, seed=0), loss=loss, dtype=F64)


def _sim3():
    data = jsynth.sim3_loop(n_poses=40, n_loops=3, scale_drift=0.005, odo_scale_std=0.005, seed=0)
    return jbuild.sim3_pose_graph(data, dtype=F64)


def _extended():
    """SE(2) poses with a second constant pose, a self-loop edge and a
    padded SE(2) prior batch; a Sim(3) block with its own priors (a second
    block shape); and a two-element euclidean block no factor touches
    (dead dofs)."""
    g = _se2(JCauchy(k=2.0))
    poses = g.blocks["poses"]
    const = np.asarray(poses.const_mask).copy()
    const[7] = True
    (fb,) = g.batches
    self_loop = dataclasses.replace(
        fb,
        indices=tuple(jnp.concatenate([i, jnp.asarray([4], i.dtype)]) for i in fb.indices),
        data={k: jnp.concatenate([v, v[:1]]) for k, v in fb.data.items()},
        weight=jnp.concatenate([fb.weight, jnp.ones(1, fb.weight.dtype)]),
    )
    T = np.asarray(poses.values)
    idx = np.array([3, 11, 20], np.int32)
    prior = JFactorBatch.create(
        kind="prior_se2", slots=("poses",), indices=(idx,),
        data={"T_obs": jnp.asarray(T[idx] @ np.asarray(jcore.se2.exp(jnp.full((3, 3), 0.05)))),
              "sqrt_info": jnp.asarray(np.broadcast_to(np.eye(3) * 5.0, (3, 3, 3)))},
        loss=JL2(), weight=jnp.asarray([1.0, 0.0, 1.0]),
    )
    S = np.asarray(jcore.sim3.exp(jnp.asarray(np.random.default_rng(3).normal(size=(4, 7)) * 0.2)))
    sim_prior = JFactorBatch.create(
        kind="prior_sim3", slots=("scaled",), indices=(np.array([0, 1, 2, 3, 1], np.int32),),
        data={"T_obs": jnp.asarray(np.concatenate([np.eye(4)[None].repeat(4, 0), S[1:2]])),
              "sqrt_info": jnp.asarray(np.broadcast_to(np.eye(7) * 2.0, (5, 7, 7)))},
        loss=JL2(),
    )
    blocks = {
        "poses": JVariableBlock(poses.kind, poses.values, jnp.asarray(const)),
        "scaled": JVariableBlock.create("sim3", jnp.asarray(S)),
        "unused": JVariableBlock.create("euclidean", jnp.zeros((2, 1), F64)),
    }
    return JFactorGraph(blocks, [self_loop, prior, sim_prior])


GRAPHS = {
    "se2": _se2,
    "se2_cauchy": lambda: _se2(JCauchy(k=2.0)),
    "sim3": _sim3,
    "se3_robust_prior": lambda: jax_graph("robust_prior"),
    "extended": _extended,
}


def _cmp(out, ref, tol=1e-10):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=tol)


# --------------------------------------------------------------------------
# Factors and manifolds
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["between_se2", "between_sim3", "prior_se2", "prior_sim3"])
def test_factor_kernels_match_reference(kind):
    rng = np.random.default_rng(len(kind))
    group, dof = (jcore.se2, 3) if "se2" in kind else (jcore.sim3, 7)
    F = 12
    mats = [np.asarray(group.exp(jnp.asarray(rng.normal(size=(F, dof)) * 0.7))) for _ in range(3)]
    sqrt_info = np.linalg.cholesky(np.eye(dof) * 3.0 + 0.1 * np.ones((dof, dof)))[None].repeat(F, 0)
    data = {"T_obs": mats[0], "sqrt_info": sqrt_info}
    vals = mats[1:] if kind.startswith("between") else mats[1:2]
    r_j, J_j = jcore.FACTOR_KERNELS[kind]({k: jnp.asarray(v) for k, v in data.items()}, *map(jnp.asarray, vals))
    r_t, J_t = tcore.FACTOR_KERNELS[kind](
        {k: torch.from_numpy(v.copy()) for k, v in data.items()}, *[torch.from_numpy(v.copy()) for v in vals]
    )
    _cmp(r_t, r_j)
    assert len(J_t) == len(J_j)
    for a, b in zip(J_t, J_j):
        _cmp(a, b)


RETRACT = {
    "so2": lambda rng: np.asarray(jcore.so2.exp(jnp.asarray(rng.normal(size=5)))),
    "so3": lambda rng: np.asarray(jcore.so3.exp(jnp.asarray(rng.normal(size=(5, 3))))),
    "se2": lambda rng: np.asarray(jcore.se2.exp(jnp.asarray(rng.normal(size=(5, 3))))),
    "sim3": lambda rng: np.asarray(jcore.sim3.exp(jnp.asarray(rng.normal(size=(5, 7)) * 0.5))),
    "euclidean": lambda rng: rng.normal(size=(5, 2, 2)),
}


@pytest.mark.parametrize("kind", sorted(RETRACT))
def test_retract_matches_reference(kind):
    rng = np.random.default_rng(7)
    values = RETRACT[kind](rng)
    dof = jcore.manifold_dof(kind, values.shape[1:])
    assert tcore.manifold_dof(kind, values.shape[1:]) == dof
    if kind != "euclidean":
        assert tcore.MANIFOLDS[kind]["shape"] == jcore.MANIFOLDS[kind]["shape"]
    dx = rng.normal(size=(5, dof)) * 0.3
    _cmp(tcore.retract(kind, torch.from_numpy(values.copy()), torch.from_numpy(dx)),
         jcore.retract(kind, jnp.asarray(values), jnp.asarray(dx)), 1e-12)


# --------------------------------------------------------------------------
# Dense assembly and the linear algebra
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_assemble_dense_matches_reference(name):
    jg = GRAPHS[name]()
    H_j, g_j, c_j = jax.jit(jas.assemble_dense)(jg)
    tg = to_port(jg)
    H_t, g_t, c_t = tas.assemble_dense(tg)
    assert_rel(H_t, H_j)
    assert_rel(g_t, g_j)
    assert_rel(c_t, c_j)
    g2, c2 = tas.gradient_and_chi2(tg)
    assert_rel(g2, g_t)
    assert_rel(c2, c_t)
    # the same plan gives the same bits on a second assembly
    plan = tas.dense_plan(tg)
    again = tas.assemble_dense(tg, plan)
    assert torch.equal(again[0], H_t) and torch.equal(again[1], g_t)


def test_dense_plan_groups_by_block_shape():
    """One reduction per block shape: (3, 3) and (7, 7) for H, 3- and
    7-wide rows for g; the self-loop's four blocks share one destination."""
    tg = to_port(_extended())
    plan = tas.dense_plan(tg)
    assert sorted(grp.shape for grp in plan.h_groups) == [(3, 3), (7, 7)]
    assert sorted(grp.shape for grp in plan.g_groups) == [(3,), (7,)]
    (fb, prior, _) = tg.batches
    h33 = next(grp for grp in plan.h_groups if grp.shape == (3, 3))
    E = 4 * fb.n + prior.n
    assert int(h33.offsets[-1]) == E and sorted(h33.perm.tolist()) == list(range(E))
    for grp in plan.h_groups + plan.g_groups:
        assert len(torch.unique(grp.pos)) == len(grp.pos)  # no two writes to one entry


def test_unit_diag_and_damping_match_reference():
    jg = _extended()
    H_j, _, _ = jax.jit(jas.assemble_dense)(jg)
    H_t, _, _ = tas.assemble_dense(to_port(jg))
    Hu_j = jas.unit_diag_where_dead(H_j)
    Hu_t = tas.unit_diag_where_dead(H_t)
    assert_rel(Hu_t, Hu_j)
    assert (np.diagonal(np.asarray(Hu_j)) != 0).all() and (np.diagonal(np.asarray(H_j)) == 0).any()
    assert_rel(tlin.damp_marquardt(Hu_t, 1e-3), jlin.damp_marquardt(Hu_j, 1e-3))
    assert_rel(H_t, H_j)  # neither call changed its argument


def test_cholesky_solve_matches_reference_and_gives_nan_when_indefinite():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(30, 30))
    H = A @ A.T + 30 * np.eye(30)
    g = rng.normal(size=30)
    assert_rel(tlin.cholesky_solve(torch.from_numpy(H), torch.from_numpy(g)),
               jlin.cholesky_solve(jnp.asarray(H), jnp.asarray(g)))
    bad = H.copy()
    bad[5, 5] = -1.0
    out = tlin.cholesky_solve(torch.from_numpy(bad), torch.from_numpy(g))
    assert torch.isnan(out).all()
    assert np.isnan(np.asarray(jlin.cholesky_solve(jnp.asarray(bad), jnp.asarray(g)))).all()


def test_dense_plan_rejects_out_of_range_index():
    """JAX clamps an out-of-range index silently; the port refuses it."""
    tg = to_port(_se2())
    fb = tg.batches[0]
    bad = dataclasses.replace(fb, indices=(fb.indices[0], fb.indices[1].clone().fill_(30)))
    with pytest.raises(ValueError, match="out of range"):
        tas.dense_plan(FactorGraph(tg.blocks, [bad]))


def test_cached_dense_plan_is_kept_by_structure():
    """``lm.solve``'s plan cache: a graph rebuilt around the same index
    tensors, or around equal ones, gets the first graph's plan; another
    index, block size or device does not; a bad index still raises."""
    tg = to_port(_se2())
    fb = tg.batches[0]
    plan = tas.cached_dense_plan(tg)
    moved = {n: dataclasses.replace(b, values=b.values + 0.1) for n, b in tg.blocks.items()}
    assert tas.cached_dense_plan(FactorGraph(moved, list(tg.batches))) is plan
    same = dataclasses.replace(fb, indices=tuple(i.clone() for i in fb.indices))
    assert tas.cached_dense_plan(FactorGraph(tg.blocks, [same] + list(tg.batches[1:]))) is plan
    other = dataclasses.replace(fb, indices=(fb.indices[1].clone(), fb.indices[0].clone()))
    assert tas.cached_dense_plan(FactorGraph(tg.blocks, [other] + list(tg.batches[1:]))) is not plan
    again = tas.assemble_dense(tg, tas.cached_dense_plan(tg))
    ref = tas.assemble_dense(tg, tas.dense_plan(tg))
    assert torch.equal(again[0], ref[0]) and torch.equal(again[1], ref[1])
    bad = dataclasses.replace(fb, indices=(fb.indices[0], fb.indices[1].clone().fill_(30)))
    with pytest.raises(ValueError, match="out of range"):
        tas.cached_dense_plan(FactorGraph(tg.blocks, [bad]))
    # a block of the same kind and count with another tangent dimension
    ext = to_port(_extended())
    name = next(n for n, b in ext.blocks.items() if b.kind == "euclidean")
    blk = ext.blocks[name]
    wider = dataclasses.replace(blk, values=torch.zeros(blk.n, blk.dof + 1, dtype=blk.values.dtype))
    wide = FactorGraph({**ext.blocks, name: wider}, list(ext.batches))
    assert tas.cached_dense_plan(wide) is not tas.cached_dense_plan(ext)
    assert tas.cached_dense_plan(wide).D == ext.total_dof + blk.n


# --------------------------------------------------------------------------
# Solves
# --------------------------------------------------------------------------


def _assert_same_solve(ts, ti, js, ji, names=("poses",)):
    assert ti.iterations == int(ji.iterations)
    assert ti.status == int(ji.status)
    np.testing.assert_array_equal(ti.accepted.numpy(), np.asarray(ji.accepted))
    np.testing.assert_allclose(ti.chi2.item(), float(ji.chi2), rtol=1e-8)
    for t_hist, j_hist in [(ti.cost_history, ji.cost_history), (ti.lambda_history, ji.lambda_history)]:
        t_hist, j_hist = t_hist.numpy(), np.asarray(j_hist)
        np.testing.assert_array_equal(np.isnan(t_hist), np.isnan(j_hist))
        np.testing.assert_allclose(t_hist, j_hist, rtol=1e-8)
    for n in names:
        np.testing.assert_allclose(
            ts.blocks[n].values.numpy(), np.asarray(js.blocks[n].values), rtol=0, atol=1e-6
        )


SOLVES = [
    ("se2", "lm", True, {}),
    ("se2", "lm", False, {}),
    ("se2", "gn", True, {}),
    ("se2", "gn", False, {}),
    ("se2", "dogleg", True, {}),
    ("se2", "dogleg", False, {}),
    ("se2", "dogleg", True, {"trust_radius_init": 1e-4}),
    ("se2_cauchy", "lm", True, {}),
    ("sim3", "lm", True, {}),
    ("sim3", "gn", True, {}),
    ("sim3", "dogleg", True, {}),
    ("se3_robust_prior", "dogleg", True, {}),
    ("extended", "lm", True, {}),
    ("extended", "gn", False, {"gn_diag_floor": 1e-6}),
]


@pytest.mark.parametrize("graph,method,speculative,extra", SOLVES)
def test_dense_solve_matches_reference(graph, method, speculative, extra):
    jg = GRAPHS[graph]()
    kw = dict(method=method, max_iters=25, speculative=speculative, **extra)
    js, ji = jlm.solve(jg, jlm.Options(**kw))
    reset_host_reads()
    ts, ti = tlm.solve(to_port(jg), tlm.Options(**kw))
    assert HOST_READS == {"pcg": 0, "lm": ti.iterations}  # one read per iteration
    _assert_same_solve(ts, ti, js, ji, names=sorted(jg.blocks))


def test_manhattan_gn_matches_reference():
    """The configuration of bench config 2 (exact GN solves, the 0.999
    cost-decrease stop) on a 200-pose Manhattan graph."""
    jg = jbuild.pose_graph(jsynth.se2_manhattan(n_poses=200, seed=1), dtype=F64)
    kw = dict(method="gn", max_iters=30, min_cost_decrease=0.999)
    js, ji = jlm.solve(jg, jlm.Options(**kw))
    ts, ti = tlm.solve(to_port(jg), tlm.Options(**kw))
    _assert_same_solve(ts, ti, js, ji)


@pytest.mark.parametrize("method", ["lm", "gn"])
def test_solve_one_iter_matches_reference(method):
    jg = _sim3()
    opts = dict(method=method)
    jn, jdx, jc = jlm.solve_one_iter(jg, jlm.Options(**opts))
    tn, tdx, tc = tlm.solve_one_iter(to_port(jg), tlm.Options(**opts))
    assert_rel(tdx, jdx)
    assert_rel(tc, jc)
    _cmp(tn.blocks["poses"].values, jn.blocks["poses"].values, 1e-9)


def test_dogleg_with_custom_path_needs_matvec():
    tg = to_port(_se2())

    def fake_assemble(graph):
        raise AssertionError("should not be called")

    with pytest.raises(ValueError, match="matvec_fn"):
        tlm.solve(tg, tlm.Options(method="dogleg"), assemble_fn=fake_assemble)
    with pytest.raises(ValueError, match="unknown method"):
        tlm.solve(tg, tlm.Options(method="newton"))


def test_pose_graph_routes_sim3_data():
    data = tsynth.sim3_loop(n_poses=12, n_loops=2, seed=0)
    g = tbuild.pose_graph(data, dtype=torch.float64, device="cpu")
    assert g.blocks["poses"].kind == "sim3" and g.batches[0].kind == "between_sim3"
    for init in ("chordal", "spanning_tree"):
        with pytest.raises(ValueError, match="Sim\\(3\\)"):
            tbuild.pose_graph(data, init=init, device="cpu")
