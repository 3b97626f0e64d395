"""SPARSE_SCHUR of the torch port (``solver/schur_sparse.py``) against the
JAX reference, in f64 on the CPU, on graphs built by the reference's
builders from numpy seeds and carried across with ``graph_from_numpy``:
2D landmark SLAM with odometry (the (pose, pose) couplings of S) and
stereo BA, plus duplicate observations, a graph whose observations name
the landmark first, and a graph with no off-diagonal S block.

Tolerances:
  * the plan's pair arrays, positions and multifrontal waves: identical;
  * ``coobservation_stats``: identical;
  * ``solve_schur_sparse``: the same iteration count, status and accept
    sequence as the JAX solve, chi2 within 1e-10 relative, values within
    1e-8; against the port's ``solve_schur(mode="dense")``: chi2 within
    1e-10 relative (the same elimination, another factorization);
  * the (landmark, pose) slot order: the same bits as (pose, landmark).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import to_port

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu.solver import schur_sparse as jss
from pyslam_tpu.solver import sparse_chol as jsc
from pyslam_tpu_torch.graph import FactorGraph, graph_from_numpy
from pyslam_tpu_torch.graph.core import FACTOR_KERNELS, register_factor
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver import schur as tschur
from pyslam_tpu_torch.solver import schur_sparse as tss
from pyslam_tpu_torch.solver.cuda_ops import LAUNCHES, reset_launches
from pyslam_tpu_torch.solver.linear import HOST_READS, reset_host_reads
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64


@pytest.fixture(autouse=True, scope="module")
def _unload_compiled_programs():
    """The reference's solves here compile a program per plan; XLA:CPU
    aborts once a few hundred are loaded in one process (tests/conftest.py),
    so they are dropped when the module is done."""
    yield
    jax.clear_caches()


def _duplicates():
    """A camera observing the same landmark twice: the pair enumeration
    includes the cross terms a block-diagonal preconditioner drops."""
    g = jbuild.ba_graph(jsynth.ba_synthetic(n_cams=8, n_pts=60, seed=1), dtype=F64)
    (fb,) = g.batches
    dup = slice(0, 15)
    data = {k: (jnp.concatenate([v, v[dup]]) if getattr(v, "ndim", 0) and v.shape[0] == fb.n else v)
            for k, v in fb.data.items()}
    idx = tuple(jnp.concatenate([i, i[dup]]) for i in fb.indices)
    return JFactorGraph(dict(g.blocks), [dataclasses.replace(fb, indices=idx, data=data,
                                                             weight=jnp.concatenate([fb.weight, fb.weight[dup]]))])


GRAPHS = {
    "lm2d": lambda: jbuild.landmark_slam_2d(
        jsynth.landmark_slam_2d(n_poses=40, n_landmarks=25, max_range=8.0, seed=3), dtype=F64),
    "stereo": lambda: jbuild.ba_graph(jsynth.ba_synthetic(n_cams=12, n_pts=200, seed=0), dtype=F64),
    "duplicates": _duplicates,
}


@functools.cache
def graphs(name):
    jg = GRAPHS[name]()
    return jg, to_port(jg)


PLAN_CASES = [("lm2d", 32), ("lm2d", 4), ("stereo", 4), ("duplicates", 4)]


@pytest.mark.parametrize("name,leaf_size", PLAN_CASES)
def test_plan_is_the_reference_plan(name, leaf_size):
    jg, tg = graphs(name)
    jp, tp = jss.build_schur_sparse_plan(jg, leaf_size=leaf_size), tss.build_schur_sparse_plan(tg, leaf_size=leaf_size)
    assert (tp.C, tp.dp, tp.n_pairs, tp.n_edges) == (jp.C, jp.dp, jp.n_pairs, jp.n_edges)
    assert tp.n_pairs > 0 and tp.n_edges > 0
    for f in ("pair_a", "pair_b", "pair_l", "pair_pos", "diag_pos", "pp_pos_ab", "pp_pos_ba"):
        np.testing.assert_array_equal(getattr(tp, f), np.asarray(getattr(jp, f)), err_msg=f)
    assert len(tp.chol.waves) == len(jp.chol.waves) and tp.chol.pool_total == jp.chol.pool_total
    for wj, wt in zip(jp.chol.waves, tp.chol.waves):
        assert tuple(wt[:3]) == tuple(wj[:3])
        for a, b in zip(wj[3:], wt[3:]):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_coobservation_stats_match_reference(name):
    jg, tg = graphs(name)
    assert tss.coobservation_stats(tg) == jss.coobservation_stats(jg)


SOLVES = [("lm2d", "lm", 20, 32), ("lm2d", "gn", 20, 4), ("stereo", "lm", 15, 4), ("duplicates", "gn", 8, 32)]


@pytest.mark.parametrize("name,method,max_iters,leaf_size", SOLVES)
def test_solve_schur_sparse_matches_reference_and_dense_schur(name, method, max_iters, leaf_size):
    jg, tg = graphs(name)
    kw = dict(method=method, max_iters=max_iters)
    jp = jss.build_schur_sparse_plan(jg, leaf_size=leaf_size)
    jsc._device_waves(jp.chol)  # the reference caches its tables outside the trace
    js, ji = jss.solve_schur_sparse(jg, jlm.Options(**kw), plan=jp)
    reset_host_reads()
    reset_launches()
    ts, ti = tss.solve_schur_sparse(tg, tlm.Options(**kw), leaf_size=leaf_size)
    assert HOST_READS == {"pcg": 0, "lm": ti.iterations}
    assert LAUNCHES["slot_reduce_plain"] > 0 and LAUNCHES["slot_reduce"] == 0
    assert ti.iterations == int(ji.iterations) and ti.status == int(ji.status)
    np.testing.assert_array_equal(ti.accepted.numpy(), np.asarray(ji.accepted))
    np.testing.assert_allclose(ti.chi2.item(), float(ji.chi2), rtol=1e-10)
    for n in jg.blocks:
        np.testing.assert_allclose(ts.blocks[n].values.numpy(), np.asarray(js.blocks[n].values), rtol=0, atol=1e-8)
    _, di = tschur.solve_schur(tg, tlm.Options(**kw), mode="dense")
    np.testing.assert_allclose(ti.chi2.item(), di.chi2.item(), rtol=1e-10)


def test_assemble_S_ell_is_the_dense_S():
    """The ELL store of S holds the blocks of the dense S of
    ``schur_solve_dense``: Hpp + PP couplings - W Hll^-1 W^T."""
    _, tg = graphs("lm2d")
    plan = tss.build_schur_sparse_plan(tg, leaf_size=4)
    parts, _, _ = tschur.ba_assemble(tg)
    lam = torch.tensor(1e-3, dtype=torch.float64)
    Hpp, Hll_inv, W, _ = tschur._schur_reduce(parts, lam, "lm")
    He = tss.assemble_S_ell(plan, tss.plan_tables(plan, "cpu"), Hpp, parts["PP"], W, Hll_inv)
    C, dp, K = plan.C, plan.dp, plan.chol.K
    S = torch.zeros(C, dp, C, dp, dtype=torch.float64)
    cols = torch.as_tensor(plan.chol.ell.cols, dtype=torch.int64)
    valid = torch.as_tensor(plan.chol.ell.valid > 0)
    rows = torch.arange(C)[:, None].expand(C, K)
    S[rows[valid], :, cols[valid], :] = He[valid]
    # the dense S from the same parts
    sp = parts["plan"]
    Hpl = torch.zeros(C, dp, sp.L, sp.dl, dtype=torch.float64)
    Hpl[sp.pair_cam, :, sp.pair_lm, :] = sp.by_pair.sum(W)
    Y = torch.einsum("alk,lkj->alj", Hpl.reshape(C * dp, sp.L, sp.dl), Hll_inv)
    S_ref = -(Y.reshape(C * dp, -1) @ Hpl.reshape(C * dp, -1).T).reshape(C, dp, C, dp)
    S_ref[torch.arange(C), :, torch.arange(C), :] += Hpp
    S_ref[sp.pp_pair_i, :, sp.pp_pair_j, :] += sp.by_pp_pair.sum(torch.cat([parts["PP"], parts["PP"].transpose(-1, -2)]))
    np.testing.assert_allclose(S.numpy(), S_ref.numpy(), rtol=0, atol=1e-10 * S_ref.abs().max().item())


# --------------------------------------------------------------------------
# An observation batch that names the landmark first
# --------------------------------------------------------------------------


@register_factor("bearing_range_se2_landmark_first")
def _bearing_range_landmark_first(data, lm, pose, compute_jacobians=True):
    r, jacs = FACTOR_KERNELS["bearing_range_se2"](data, pose, lm, compute_jacobians=compute_jacobians)
    return r, jacs[::-1]


def landmark_first(graph):
    """The same graph with its observation batch's slots in the order
    (landmark, pose)."""
    batches = [
        dataclasses.replace(fb, kind=fb.kind + "_landmark_first", slots=fb.slots[::-1], indices=fb.indices[::-1])
        if fb.slots == ("poses", "landmarks") else fb
        for fb in graph.batches
    ]
    return FactorGraph(graph.blocks, batches)


@pytest.mark.parametrize("method", ["lm", "gn"])
def test_landmark_first_slot_order_gives_the_same_solve(method):
    _, tg = graphs("lm2d")
    swapped = landmark_first(tg)
    assert {fb.slots for fb in swapped.batches} == {("landmarks", "poses"), ("poses", "poses")}
    opts = tlm.Options(method=method, max_iters=20)
    plan_a, plan_b = tss.build_schur_sparse_plan(tg, leaf_size=4), tss.build_schur_sparse_plan(swapped, leaf_size=4)
    for f in ("pair_a", "pair_b", "pair_l", "pair_pos", "pp_pos_ab"):
        np.testing.assert_array_equal(getattr(plan_a, f), getattr(plan_b, f))
    sa, ia = tss.solve_schur_sparse(tg, opts, plan=plan_a)
    sb, ib = tss.solve_schur_sparse(swapped, opts, plan=plan_b)
    assert ia.iterations == ib.iterations and torch.equal(ia.accepted, ib.accepted)
    assert torch.equal(ia.chi2, ib.chi2)
    for n in tg.blocks:
        assert torch.equal(sa.blocks[n].values, sb.blocks[n].values)
    _, idense = tschur.solve_schur(swapped, opts, mode="dense")
    np.testing.assert_allclose(ib.chi2.item(), idense.chi2.item(), rtol=1e-10)


def test_plan_survives_single_camera_graph():
    """All observations from ONE pose: S has no off-diagonal block at all."""
    rng = np.random.default_rng(1)
    L = 12
    lm_gt = rng.normal(size=(L, 2)) + np.array([4.0, 0.0])
    obs = lm_gt + rng.normal(0, 0.01, (L, 2))
    tg = graph_from_numpy(
        {"poses": dict(kind="se2", values=np.eye(3)[None], const_mask=np.array([True])),
         "landmarks": dict(kind="euclidean", values=lm_gt + rng.normal(0, 0.3, (L, 2)), const_mask=np.zeros(L, bool))},
        [dict(kind="landmark_xy_se2", slots=("poses", "landmarks"), indices=[np.zeros(L, np.int64), np.arange(L)],
              data={"obs": obs, "sqrt_info": np.tile(np.eye(2) * 10, (L, 1, 1))}, weight=np.ones(L),
              loss=("L2Loss", {}))],
        dtype=torch.float64, device="cpu",
    )
    plan = tss.build_schur_sparse_plan(tg)
    assert plan.n_edges == 0 and plan.n_pairs == L
    _, i1 = tss.solve_schur_sparse(tg, tlm.Options(method="gn", max_iters=8), plan=plan)
    _, i2 = tschur.solve_schur(tg, tlm.Options(method="gn", max_iters=8), mode="dense")
    np.testing.assert_allclose(i1.chi2.item(), i2.chi2.item(), rtol=1e-10)


def test_plans_are_reused_by_content():
    """Repeated solves over one sparsity build the plan once; another
    structure builds its own."""
    _, tg = graphs("stereo")
    opts = tlm.Options(method="lm", max_iters=3)
    tss.solve_schur_sparse(tg, opts)
    n = len(tss._PLANS)
    moved = tg.with_values({k: dataclasses.replace(b, values=b.values * 1.0) for k, b in tg.blocks.items()})
    tss.solve_schur_sparse(moved, opts)
    assert len(tss._PLANS) == n
    tss.solve_schur_sparse(tg, opts, leaf_size=8)
    assert len(tss._PLANS) == n + 1


def test_structure_graph_kinds_are_never_evaluated():
    """The structure-only graph of the plan names kinds no factor registry
    has; building the ELL store never looks them up."""
    assert "structure_pp" not in FACTOR_KERNELS and "structure_coobs" not in FACTOR_KERNELS
    jg, tg = graphs("stereo")
    assert tss.build_schur_sparse_plan(tg).n_pairs == jss.build_schur_sparse_plan(jg).n_pairs


def test_schur_plan_takes_both_slot_orders_of_an_observation_batch():
    _, tg = graphs("lm2d")
    swapped = landmark_first(tg)
    a, b = tschur.schur_plan(tg), tschur.schur_plan(swapped)
    assert "obs_lp" in b.roles and "obs" not in b.roles
    for f in ("cam_idx", "pt_idx", "pair_cam", "pair_lm", "pp_i", "pp_j"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    pa, ga, ca = tschur.ba_assemble(tg, plan=a)
    pb, gb, cb = tschur.ba_assemble(swapped, plan=b)
    for k in ("Hpp", "Hll", "W", "PP", "g_p", "g_l"):
        assert torch.equal(pa[k], pb[k]), k
    assert torch.equal(ga, gb) and torch.equal(ca, cb)
