"""Venice-scale bundle adjustment of the torch port (``solver/schur_large.py``)
against the JAX reference's ``solve_schur_large``, in f64 on the CPU, on
the reference's test graphs carried across with ``graph_from_numpy``:
stereo ``ba_synthetic(8, 64)`` and the perturbed ``synthetic_bal(6, 50)``
(``tests/test_schur_large.py``).

Tolerances: the same LM iterations, stop code and accept sequence (the
lambdas each linear solve was given), the accepted-cost history within
1e-9 relative, poses and landmarks within 1e-8.  Knobs that must not change
a result are held to the same bits: ``plan=`` reuse, ``dual_order``, the
observation batch's slot order.

The reference tests without a counterpart here, and why:
  * ``TestClosedKernelRegistry::test_content_keyed_names``: the registry
    keys jit caches by the content of a closure's data; the port has no
    jit cache, and its ``register_closed_kernel`` names are held to content
    in ``tests/test_torch_autodiff_factor.py``
    (``test_closed_kernel_names_follow_content``).
  * ``TestPCGSegmentBreakdown::test_exact_convergence_mid_segment_freezes``:
    the port has no host-driven CG segments (a TPU runtime limit); the
    breakdown guard it tests is held here on the port's one loop
    (``test_pcg_breakdown_guard_freezes_the_state``).
  * ``TestDualOrder::test_dual_order_bal``'s cumsum layout: the dual
    order has no effect here (``test_dual_order_has_no_effect``).

``TestClusterPrecond`` (the cluster and stale-S preconditioners) is held
case by case against the reference (``SOLVES``), with its pair tables and
against the Jacobi preconditioner's optimum and CG iterations.
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import to_port

import pyslam_tpu.solver.host_loop as j_host_loop
import pyslam_tpu_torch.solver.schur_large as tsl
from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorBatch as JFactorBatch
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.io import bal as jbal
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.losses import CauchyLoss as JCauchy
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu.solver.schur_large import build_dense_pairs as j_build_dense_pairs
from pyslam_tpu.solver.schur_large import prepare_large_ba as j_prepare_large_ba
from pyslam_tpu.solver.schur_large import solve_schur_large as j_solve
from pyslam_tpu_torch.graph import FactorGraph
from pyslam_tpu_torch.graph import build as tbuild
from pyslam_tpu_torch.graph.core import FACTOR_KERNELS, register_factor
from pyslam_tpu_torch.io import bal as tbal
from pyslam_tpu_torch.losses import CauchyLoss, HuberLoss, L1Loss, L2Loss, TDistributionLoss, TukeyLoss
from pyslam_tpu_torch.solver import cuda_ops
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver.linear import HOST_READS, reset_host_reads

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import profile_port  # noqa: E402  (the repository root's script, for its plain CG loop)
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64


@pytest.fixture(autouse=True, scope="module")
def _unload_compiled_programs():
    """The reference's solves compile programs per shape; they are dropped
    when the module is done (XLA:CPU aborts with too many loaded)."""
    yield
    jax.clear_caches()


@register_factor("reprojection_landmark_first")
def _landmark_first_kernel(data, lm, pose, compute_jacobians=True):
    r, jacs = FACTOR_KERNELS["reprojection"](data, pose, lm, compute_jacobians=compute_jacobians)
    return r, (jacs[::-1] if compute_jacobians else None)


@register_factor("reprojection_bal_landmark_first")
def _bal_landmark_first_kernel(data, lm, pose, compute_jacobians=True):
    r, jacs = FACTOR_KERNELS["reprojection_bal"](data, pose, lm, compute_jacobians=compute_jacobians)
    return r, (jacs[::-1] if compute_jacobians else None)


# --------------------------------------------------------------------------
# Graphs (reference first, then carried across)
# --------------------------------------------------------------------------


def _stereo(seed=3, loss=None, n_pts=64, obs_per_pt=4):
    return jbuild.ba_graph(jsynth.ba_synthetic(n_cams=8, n_pts=n_pts, obs_per_pt=obs_per_pt, seed=seed),
                           loss=loss, dtype=F64)


def _bal(seed=0):
    return jbuild.bal_graph(jbal.perturbed(jbal.synthetic_bal(n_cams=6, n_pts=50, seed=seed)), dtype=F64)


def _with_batches(g, extra):
    return JFactorGraph(dict(g.blocks), [g.batches[0], *extra])


def _prior(g):
    """A stiff prior on camera 0 (``TestSchurLargeUnary``)."""
    T0 = np.asarray(g.blocks["poses"].values[:1])
    return JFactorBatch.create(kind="prior_se3", slots=("poses",), indices=(np.array([0], np.int32),),
                               data={"T_obs": jnp.asarray(T0, F64), "sqrt_info": 1e3 * jnp.eye(6, dtype=F64)[None]},
                               loss=JL2())


def _between(seed=12):
    """Observations and an odometry chain (``TestSchurLargeBetween``)."""
    data = jsynth.ba_synthetic(n_cams=8, n_pts=64, obs_per_pt=4, seed=seed)
    g = jbuild.ba_graph(data, dtype=F64)
    Ti = np.arange(7, dtype=np.int32)
    T_obs = np.stack([data.T_gt[j] @ np.linalg.inv(data.T_gt[i]) for i, j in zip(Ti, Ti + 1)])
    between = JFactorBatch.create(kind="between_se3", slots=("poses", "poses"), indices=(Ti, Ti + 1),
                                  data={"T_obs": jnp.asarray(T_obs, F64),
                                        "sqrt_info": jnp.broadcast_to(10.0 * jnp.eye(6, dtype=F64), (7, 6, 6))},
                                  loss=JL2())
    return _with_batches(g, [between])


def _gauge(g):
    """Cameras 0 and 3 frozen."""
    pb = g.blocks["poses"]
    blocks = dict(g.blocks)
    blocks["poses"] = dataclasses.replace(pb, const_mask=pb.const_mask.at[3].set(True))
    return JFactorGraph(blocks, g.batches)


GRAPHS = {
    "stereo": lambda: _stereo(),
    "bal": lambda: _bal(),
    "stereo_cauchy": lambda: _stereo(loss=JCauchy(2.0)),
    "stereo_gauge": lambda: _gauge(_stereo()),
    "stereo_prior": lambda: _with_batches(_stereo(seed=11), [_prior(_stereo(seed=11))]),
    "between": lambda: _between(),
}


@functools.lru_cache(maxsize=None)
def graphs(name):
    jg = GRAPHS[name]()
    return jg, to_port(jg)


def landmark_first(graph):
    """The graph with its observation batch's slots (landmark, pose), the
    kind of the same name with ``_landmark_first``."""
    return FactorGraph(graph.blocks, [
        dataclasses.replace(fb, kind=fb.kind + "_landmark_first", slots=fb.slots[::-1], indices=fb.indices[::-1])
        if fb.slots == ("poses", "landmarks") else fb for fb in graph.batches])


# --------------------------------------------------------------------------
# Solves, with the LM loop's decisions recorded
# --------------------------------------------------------------------------


def _recording(loop, record):
    """``loop`` (either host loop) with the lambda of every linear solve
    and the final ``info`` recorded."""

    def speculative(linearize, solve_from, state, options, on_accept=None):
        def solve(state, lin, lam):
            record["lams"].append(lam)
            return solve_from(state, lin, lam)

        out = loop(linearize, solve, state, options, on_accept)
        record["info"] = out[2]
        return out

    def classic(step, state, options, on_accept=None):
        def recorded(state, lam):
            record["lams"].append(lam)
            return step(state, lam)

        out = loop(recorded, state, options, on_accept)
        record["info"] = out[2]
        return out

    return speculative if loop.__name__.endswith("speculative") else classic


def solve_both(monkeypatch, name, opts, jax_kw=None, **kw):
    """(JAX, port) results of one solve: each (solved, chi2, history,
    record)."""
    jg, tg = graphs(name)
    out = []
    for solve, module, g, options in ((j_solve, j_host_loop, jg, jlm.Options(**opts)),
                                      (tsl.solve_schur_large, tsl, tg, tlm.Options(**opts))):
        record = {"lams": []}
        for loop in ("host_lm_loop", "host_lm_loop_speculative"):
            monkeypatch.setattr(module, loop, _recording(getattr(j_host_loop if module is j_host_loop else tsl, loop),
                                                         record))
        args = {**kw, **(jax_kw or {})} if solve is j_solve else kw
        out.append((*solve(g, options, **args), record))
        monkeypatch.undo()
    return out


def assert_same_solve(j, t, rel=1e-9, state=1e-8):
    (js, jc, jh, jr), (ts, tc, th, tr) = j, t
    assert (tr["info"]["iterations"], tr["info"]["status"]) == (jr["info"]["iterations"], jr["info"]["status"])
    np.testing.assert_allclose(tr["lams"], jr["lams"], rtol=1e-12)  # the accept sequence
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, jh, rtol=rel)
    np.testing.assert_allclose(tc, jc, rtol=rel)
    for n in ("poses", "landmarks"):
        np.testing.assert_allclose(ts.blocks[n].values.numpy(), np.asarray(js.blocks[n].values), rtol=0, atol=state)


# --------------------------------------------------------------------------
# Against the reference
# --------------------------------------------------------------------------

SOLVES = {
    # graph, LM options, solve_schur_large options
    "stereo": ("stereo", dict(method="lm", max_iters=20), dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=60)),
    "stereo_default_budget": ("stereo", dict(method="lm", max_iters=12), dict(n_chunks=4)),
    "bal": ("bal", dict(method="lm", max_iters=20), dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=60)),
    "cauchy": ("stereo_cauchy", dict(method="lm", max_iters=12), dict(n_chunks=4)),
    "gauge": ("stereo_gauge", dict(method="lm", max_iters=10), dict(n_chunks=4)),
    "prior": ("stereo_prior", dict(method="lm", max_iters=15), dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=60)),
    "between": ("between", dict(method="lm", max_iters=20), dict(n_chunks=4, pcg_rtol=1e-12, pcg_max_iters=60)),
    "gn": ("stereo", dict(method="gn", max_iters=8), dict(n_chunks=2)),
    "classic": ("stereo", dict(method="lm", max_iters=12), dict(n_chunks=4, speculative=False)),
    "dense_stereo": ("stereo", dict(method="lm", max_iters=15), dict(n_chunks=4, linear="dense")),
    "dense_bal": ("bal", dict(method="lm", max_iters=15), dict(n_chunks=4, linear="dense")),
    "dense_between": ("between", dict(method="lm", max_iters=15), dict(n_chunks=4, linear="dense")),
    # the reference's TestClusterPrecond: cluster block-Jacobi (a cluster
    # size that divides C, and one that pads the last cluster) and the
    # stale-S factor refreshed every solve or every few
    "cluster2": ("stereo", dict(method="lm", max_iters=15),
                 dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=50, precond="cluster", cluster_size=2)),
    "cluster4": ("stereo", dict(method="lm", max_iters=15),
                 dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=50, precond="cluster", cluster_size=4)),
    "cluster_between": ("between", dict(method="lm", max_iters=15),
                        dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=50, precond="cluster", cluster_size=3)),
    "cluster_default_budget": ("stereo_cauchy", dict(method="lm", max_iters=12),
                               dict(n_chunks=4, precond="cluster", cluster_size=3)),
    "stale1": ("stereo", dict(method="lm", max_iters=15),
               dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=50, precond="stale", stale_refresh=1)),
    "stale3": ("stereo", dict(method="lm", max_iters=15),
               dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=50, precond="stale", stale_refresh=3)),
    "stale_between": ("between", dict(method="lm", max_iters=15),
                      dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=50, precond="stale", stale_refresh=2)),
    "stale_classic": ("stereo_prior", dict(method="lm", max_iters=10),
                      dict(n_chunks=4, precond="stale", stale_refresh=2, speculative=False)),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_matches_reference(monkeypatch, case):
    name, opts, kw = SOLVES[case]
    j, t = solve_both(monkeypatch, name, opts, **kw)
    assert_same_solve(j, t)
    ts, _, th, _ = t
    assert th[-1] < th[0]
    _, tg = graphs(name)
    for n, b in tg.blocks.items():  # frozen elements stay where they were
        assert torch.equal(ts.blocks[n].values[b.const_mask], b.values[b.const_mask])


def test_dense_matches_pcg():
    """``linear="dense"`` reaches tight PCG's optimum (the reference's
    ``TestDenseLinear``)."""
    _, tg = graphs("stereo")
    opts = tlm.Options(method="lm", max_iters=15)
    _, c_pcg, _ = tsl.solve_schur_large(tg, opts, n_chunks=4, pcg_rtol=1e-12, pcg_max_iters=60)
    _, c_dense, _ = tsl.solve_schur_large(tg, opts, n_chunks=4, linear="dense")
    np.testing.assert_allclose(c_dense, c_pcg, rtol=1e-8)


def test_dense_pairs_are_the_reference_pairs():
    """The co-observation pairs, in the reference's camera order and
    orientation (its padding rows aside)."""
    jg, tg = graphs("stereo")
    jp = j_build_dense_pairs(j_prepare_large_ba(jg, 4), 4)
    tp = tsl.build_dense_pairs(tsl.prepare_large_ba(tg, 4), 4)
    real = np.asarray(jp.pair_w) > 0
    for f in ("pair_a", "pair_b"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f))[real])


@pytest.mark.parametrize("G", [2, 3, 4])
def test_cluster_pairs_are_the_reference_pairs(G):
    """``build_cluster_pairs``: the reference's same-cluster pairs in its
    order and orientation (its padding rows aside), and the blocks they
    and the diagonal and same-cluster couplings fill are the reference's
    buckets q = cid G² + la G + lb."""
    from pyslam_tpu.solver.schur_large import build_cluster_pairs as j_build_cluster_pairs

    jg, tg = graphs("between")
    jp = j_build_cluster_pairs(j_prepare_large_ba(jg, 4), G, 4)
    tp = tsl.build_cluster_pairs(tsl.prepare_large_ba(tg, 4), G, 4)
    real = np.asarray(jp.pair_w) > 0
    for f in ("pair_a", "pair_b"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f))[real])
    C = tg.blocks["poses"].n
    cams = np.arange(-(-C // G) * G)
    pi, pj = np.arange(7), np.arange(1, 8)  # the graph's odometry chain
    same = pi // G == pj // G
    j_buckets = np.concatenate([np.asarray(jp.pair_q)[real], (cams // G) * G * G + (cams % G) * (G + 1),
                                (pi // G * G * G + pi % G * G + pj % G)[same]])
    bi, bj = tp.block_i.numpy(), tp.block_j.numpy()
    np.testing.assert_array_equal(np.sort(bi // G * G * G + bi % G * G + bj % G), np.unique(j_buckets))
    np.testing.assert_array_equal(tp.pp_rows.numpy(), np.flatnonzero(same))


@pytest.mark.parametrize("precond,kw", [("cluster", dict(cluster_size=2)), ("cluster", dict(cluster_size=3)),
                                        ("stale", dict(stale_refresh=1)), ("stale", dict(stale_refresh=3))])
def test_preconditioners_reach_the_jacobi_optimum(precond, kw):
    """The reference's ``TestClusterPrecond``: a preconditioner changes the
    CG path, not the optimum (chi2 within 1e-8 of ``jacobi``'s), and the
    exact cluster blocks or the dense S need no more CG iterations a
    linear solve than the 6 x 6 block diagonal."""
    _, tg = graphs("stereo")
    opts = dict(method="lm", max_iters=15)
    common = dict(n_chunks=4, pcg_rtol=1e-10, pcg_max_iters=50)
    tsl.reset_cg_iterations()
    _, c_j, h_j = _solve(tg, opts, **common)
    its_j = tsl.cg_iterations()
    tsl.reset_cg_iterations()
    _, c_p, h_p = _solve(tg, opts, precond=precond, **common, **kw)
    its_p = tsl.cg_iterations()
    np.testing.assert_allclose(c_p, c_j, rtol=1e-8)
    assert len(its_p) == len(its_j) and all(a <= b for a, b in zip(its_p, its_j)), (its_p, its_j)
    if precond == "stale" and kw["stale_refresh"] == 1:
        assert all(n <= 2 for n in its_p)  # S's own factor: one iteration, a second for rounding


def test_stale_refreshes_every_few_solves_rejections_included(monkeypatch):
    """The stale factor is rebuilt at the first linear solve and whenever
    ``stale_refresh`` solves have used it, rejected LM steps counted."""
    _, tg = graphs("bal")
    built = []
    factor = tsl._stale_factor
    monkeypatch.setattr(tsl, "_stale_factor", lambda *a: built.append(1) or factor(*a))
    lams = []
    loop = tsl.host_lm_loop_speculative

    def recorded(linearize, solve_from, state, options, on_accept=None):
        def solve(state, lin, lam):
            lams.append((lam, len(built)))
            return solve_from(state, lin, lam)

        return loop(linearize, solve, state, options, on_accept)

    monkeypatch.setattr(tsl, "host_lm_loop_speculative", recorded)
    _, _, hist = _solve(tg, dict(method="lm", max_iters=12, min_cost_decrease=1.0 - 1e-15), n_chunks=4,
                        precond="stale", stale_refresh=3)
    n = len(lams)
    assert n > len(hist) > 2  # some steps were rejected
    assert len(built) == -(-n // 3)
    assert [b for _, b in lams] == [-(-k // 3) for k in range(n)]  # factors built before solve k


def test_plan_caches_cluster_and_stale_pairs():
    """The pair tables are built once and kept on the plan (the reference's
    ``test_plan_caches_cluster_pairs`` and
    ``test_stale_reuses_dense_pair_tables``); another cluster size
    rebuilds them."""
    _, tg = graphs("stereo")
    opts = dict(method="lm", max_iters=4)
    plan = tsl.prepare_large_ba(tg, 4)
    a = _solve(tg, opts, n_chunks=4, plan=plan, precond="cluster", cluster_size=4)
    cp = plan.cpairs
    assert cp is not None and plan.cpairs_G == 4 and plan.pairs is None
    b = _solve(tg, opts, n_chunks=4, plan=plan, precond="cluster", cluster_size=4)
    assert plan.cpairs is cp
    assert_bits(a, b)
    _solve(tg, opts, n_chunks=4, plan=plan, precond="cluster", cluster_size=3)
    assert plan.cpairs is not cp and plan.cpairs_G == 3
    _solve(tg, opts, n_chunks=4, plan=plan, precond="stale")
    pairs = plan.pairs
    assert pairs is not None
    _solve(tg, opts, n_chunks=4, plan=plan, precond="stale")
    assert plan.pairs is pairs


# --------------------------------------------------------------------------
# Knobs that change no result
# --------------------------------------------------------------------------


def _solve(tg, opts, **kw):
    solved, chi2, hist = tsl.solve_schur_large(tg, tlm.Options(**opts), **kw)
    return solved, chi2, hist


def assert_bits(a, b):
    assert a[2] == b[2] and a[1] == b[1]
    for n in a[0].blocks:
        assert torch.equal(a[0].blocks[n].values, b[0].blocks[n].values)


def test_chunk_count_changes_nothing():
    """1 chunk against 7 (the last one short): the rows of every
    observation are summed once, in plan order, whatever the chunking."""
    _, tg = graphs("stereo")
    opts = dict(method="lm", max_iters=8)
    assert_bits(_solve(tg, opts, n_chunks=1), _solve(tg, opts, n_chunks=7))


def test_plan_reuse_gives_the_same_bits():
    _, tg = graphs("stereo")
    opts = dict(method="lm", max_iters=6)
    plan = tsl.prepare_large_ba(tg, 4)
    a = _solve(tg, opts, n_chunks=4)
    b = _solve(tg, opts, n_chunks=4, plan=plan)
    c = _solve(tg, opts, n_chunks=4, plan=plan)  # reused twice
    assert_bits(a, b)
    assert_bits(b, c)


def test_plan_caches_pairs():
    _, tg = graphs("stereo")
    plan = tsl.prepare_large_ba(tg, 4)
    opts = dict(method="lm", max_iters=10)
    a = _solve(tg, opts, n_chunks=4, linear="dense", plan=plan)
    pairs = plan.pairs
    assert pairs is not None
    b = _solve(tg, opts, n_chunks=4, linear="dense", plan=plan, speculative=False)
    assert plan.pairs is pairs  # reused, not rebuilt
    np.testing.assert_allclose(a[2], b[2], rtol=1e-12)


@pytest.mark.parametrize("linear", ["pcg", "dense"])
def test_speculative_matches_classic(linear):
    _, tg = graphs("stereo_cauchy")
    opts = dict(method="lm", max_iters=15)
    a = _solve(tg, opts, n_chunks=4, linear=linear, speculative=False)
    b = _solve(tg, opts, n_chunks=4, linear=linear, speculative=True)
    assert len(a[2]) == len(b[2])
    np.testing.assert_allclose(a[2], b[2], rtol=1e-12)
    np.testing.assert_allclose(a[1], b[1], rtol=1e-12)


def test_dual_order_has_no_effect():
    _, tg = graphs("bal")
    opts = dict(method="lm", max_iters=10)
    assert_bits(_solve(tg, opts, n_chunks=3, dual_order=False), _solve(tg, opts, n_chunks=3, dual_order=True))


@pytest.mark.parametrize("linear", ["pcg", "dense"])
def test_landmark_first_slot_order_gives_the_same_bits(linear):
    """The reference's ``prepare_large_ba`` takes only (pose, landmark)
    observations; the port's ``route_auto`` sends a (landmark, pose) graph
    to this route too, and both orders solve alike."""
    _, tg = graphs("between")
    swapped = landmark_first(tg)
    assert {fb.slots for fb in swapped.batches} == {("landmarks", "poses"), ("poses", "poses")}
    opts = dict(method="lm", max_iters=10)
    assert_bits(_solve(tg, opts, n_chunks=4, linear=linear), _solve(swapped, opts, n_chunks=4, linear=linear))


# --------------------------------------------------------------------------
# Known divergence: the CG stop test at budgets over 60
# --------------------------------------------------------------------------


def test_pcg_budget_over_60_tests_every_iteration(monkeypatch):
    """The reference runs budgets over 60 in host segments of 25 that test
    the residual once a segment, so a solve whose CG converges inside a
    segment runs on to its end there; the port tests before every iteration
    at every budget.  At a budget of 70 the port's solve is the reference's
    at 60 (its fused loop, the same stop rule), and the reference's own
    solve at 70 differs from it."""
    opts = dict(method="lm", max_iters=6)
    j60, t60 = solve_both(monkeypatch, "stereo", opts, n_chunks=4, pcg_rtol=1e-8, pcg_max_iters=60)
    j70, t70 = solve_both(monkeypatch, "stereo", opts, n_chunks=4, pcg_rtol=1e-8, pcg_max_iters=70)
    tsl.reset_cg_iterations()
    _, tg = graphs("stereo")
    _solve(tg, opts, n_chunks=4, pcg_rtol=1e-8, pcg_max_iters=70)
    # every solve stopped on its tolerance before 60 and off a segment's end
    assert all(n < 60 and n % 25 for n in tsl.cg_iterations())
    assert_same_solve(j60, t70)
    assert_bits(t60[:3], t70[:3])
    assert j70[2] != j60[2]  # the reference's segments ran on


def test_pcg_breakdown_guard_freezes_the_state():
    """rz <= 0 or pAp <= 0 keeps x, r and p as they are (the reference's
    guard): a zero preconditioner and an indefinite operator give a finite
    x, where the plain recurrences divide 0 by 0."""
    b = torch.ones(6, dtype=torch.float64)
    x, it = tsl._pcg(lambda p: p, lambda r: 0.0 * r, b, 1e-12, 10)
    assert torch.equal(x, torch.zeros(6, dtype=torch.float64)) and it == 10
    x, _ = tsl._pcg(lambda p: -p, lambda r: r, b, 1e-12, 10)
    assert torch.isfinite(x).all() and not x.any()
    # an exact solve in one step, then frozen at the solution
    x, it = tsl._pcg(lambda p: 2.0 * p, lambda r: 0.5 * r, b, 0.0, 10)
    assert torch.equal(x, 0.5 * b) and it == 1


@pytest.mark.parametrize("read_every", [1, 3, 0])
def test_masked_pcg_of_the_profile_gives_the_same_iterate(read_every):
    """``_pcg`` (the stop test applied on the device and read every n
    iterations, or never) gives the iterate and count of
    ``profile_port.pcg_guarded_plain`` (the test read before every
    iteration, which the profile times it against), with n times fewer
    reads."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(30, 30))
    A = torch.from_numpy(A @ A.T + 30 * np.eye(30))
    b = torch.from_numpy(rng.normal(size=30))
    d = torch.diagonal(A)
    reset_host_reads()
    ref, n_ref = profile_port.pcg_guarded_plain(lambda p: A @ p, lambda r: r / d, b, 1e-8, 25)
    assert HOST_READS["pcg"] == n_ref + 1 and n_ref < 25
    reset_host_reads()
    x, n = tsl._pcg(lambda p: A @ p, lambda r: r / d, b, 1e-8, 25, read_every=read_every)
    assert torch.equal(x, ref) and int(n) == n_ref
    assert HOST_READS["pcg"] == (0 if read_every == 0 else -(-n_ref // read_every) + 1)
    x, _ = tsl._pcg(lambda p: -p, lambda r: r, b, 1e-12, 10, read_every=read_every)
    assert not x.any()  # the breakdown guard
    assert tsl.CG_READ_EVERY == 0  # what the solver runs


@pytest.mark.parametrize("read_every", [1, 4, 0])
def test_pcg_on_a_block_runs_each_column_as_alone(read_every):
    """``_pcg`` on a block (n, m): each column's iterate and count are those
    of the column solved alone (its own stop test, frozen once it fails),
    a zero column runs no iteration, and the host reads whether any column
    runs every ``read_every`` iterations, ending the loop when none does."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(40, 40))
    A = torch.from_numpy(A @ A.T + 40 * np.eye(40))
    d = torch.diagonal(A)
    B = torch.from_numpy(rng.normal(size=(40, 5)))
    B[:, 1] = 0.0
    B[:, 3] = B[:, 3] * 1e-6  # a small column: each stop test is relative to its own norm
    B[:, 4] = A[:, 7] * 2.0  # A x = b with x = 2 e_7: a fast column

    def matvec(P):
        return A @ P

    def precond(R):
        return R / (d[:, None] if R.dim() == 2 else d)

    reset_host_reads()
    X, its = tsl._pcg(matvec, precond, B, 1e-9, 60, read_every=read_every)
    reads = HOST_READS["pcg"]
    assert X.shape == B.shape and its.shape == (5,)
    assert its[1] == 0 and not X[:, 1].any()
    for j in (0, 2, 3, 4):
        x, n = tsl._pcg(matvec, precond, B[:, j].contiguous(), 1e-9, 60, read_every=0)
        assert int(its[j]) == int(n) < 60
        np.testing.assert_allclose(X[:, j].numpy(), x.numpy(), rtol=0, atol=1e-12 * float(x.abs().max()))
    assert reads == (0 if read_every == 0 else -(-int(its.max()) // read_every) + 1)


# --------------------------------------------------------------------------
# Errors
# --------------------------------------------------------------------------


def test_unported_preconditioners_raise():
    """The preconditioners that once raised here solve now; what still
    raises is the reference's budget check, before any pair table is built
    (the plan stays as it was), and a bad ``linear`` or ``precond``."""
    _, tg = graphs("stereo")
    plan = tsl.prepare_large_ba(tg, 4)
    opts = tlm.Options(method="lm", max_iters=3)
    for precond in ("cluster", "stale"):
        with pytest.raises(ValueError, match="fused"):  # the reference's budget check comes first
            tsl.solve_schur_large(tg, opts, plan=plan, precond=precond, pcg_max_iters=100)
    assert plan.pairs is None and plan.cpairs is None
    for precond in ("cluster", "stale"):
        _, chi2, hist = tsl.solve_schur_large(tg, opts, plan=plan, precond=precond, cluster_size=3)
        assert np.isfinite(chi2) and chi2 < hist[0]
    with pytest.raises(ValueError, match="linear"):
        tsl.solve_schur_large(tg, opts, plan=plan, linear="cholmod")
    with pytest.raises(ValueError, match="precond"):
        tsl.solve_schur_large(tg, opts, plan=plan, precond="ilu")
    # linear="dense" ignores precond, as in the reference
    _, chi2, hist = tsl.solve_schur_large(tg, opts, plan=plan, linear="dense", precond="cluster")
    assert chi2 < hist[0]


def test_plan_validation():
    _, tg = graphs("stereo")
    pb = tg.blocks["poses"]
    with pytest.raises(ValueError, match="se3 poses"):
        blocks = dict(tg.blocks)
        blocks["landmarks"] = dataclasses.replace(blocks["landmarks"], values=blocks["landmarks"].values[:, :2])
        tsl.prepare_large_ba(FactorGraph(blocks, tg.batches))
    with pytest.raises(ValueError, match="one pose-landmark batch"):
        tsl.prepare_large_ba(FactorGraph(tg.blocks, tg.batches * 2))
    fb = tg.batches[0]
    bad = dataclasses.replace(fb, indices=(fb.indices[0] + pb.n - 1, fb.indices[1]))
    with pytest.raises(ValueError, match="out of range"):
        tsl.prepare_large_ba(FactorGraph(tg.blocks, [bad]))


# --------------------------------------------------------------------------
# bal_rows: the BAL observations' rows in one kernel (its plain twin here)
# --------------------------------------------------------------------------

# every loss cuda_ops.kernel_loss takes
BAL_LOSSES = {
    "l2": L2Loss(), "l1": L1Loss(), "cauchy": CauchyLoss(2.0), "huber": HuberLoss(1.0), "tukey": TukeyLoss(3.0),
    "student_t": TDistributionLoss(5.0, 1.5),
}


def _port_bal(loss=None, per_obs_info=False, seed=0):
    """A perturbed ``synthetic_bal(6, 50)`` on the port, f64 on the CPU, with
    random weights and, with ``per_obs_info``, one random sqrt_info an
    observation (upper triangular, positive diagonal)."""
    g = tbuild.bal_graph(tbal.perturbed(tbal.synthetic_bal(n_cams=6, n_pts=50, seed=seed)), loss=loss,
                         dtype=torch.float64, device="cpu")
    (fb,) = g.batches
    rng = np.random.default_rng(seed + 7)
    data = dict(fb.data)
    if per_obs_info:
        info = np.zeros((fb.n, 2, 2))
        info[:, [0, 1], [0, 1]] = rng.uniform(0.5, 1.5, size=(fb.n, 2))
        info[:, 0, 1] = rng.uniform(-0.3, 0.3, size=fb.n)
        data["sqrt_info"] = torch.from_numpy(info)
    weight = torch.from_numpy(rng.uniform(0.5, 2.0, size=fb.n))
    return FactorGraph(g.blocks, [dataclasses.replace(fb, data=data, weight=weight)])


def _bal_args(plan):
    return tsl.bal_rows_args(plan, plan.poses, plan.lms)


def _assert_rows_close(out, ref, rel):
    """Each column within ``rel`` of its largest reference entry."""
    assert out.shape == ref.shape
    scale = ref.abs().amax(0).clamp(min=1e-300)
    assert ((out - ref).abs() <= rel * scale).all(), ((out - ref).abs() / scale).max().item()


@pytest.mark.parametrize("n_chunks", [1, 4, 7])
@pytest.mark.parametrize("order", ["pose_first", "landmark_first"])
@pytest.mark.parametrize("info", ["shared", "per_observation"])
@pytest.mark.parametrize("loss", sorted(BAL_LOSSES))
def test_bal_rows_plain_matches_the_chunked_path(loss, info, order, n_chunks):
    """``cuda_ops.bal_rows_plain`` (the kernel's twin) over the whole axis
    gives the chunked path's cost and rows within 1e-12 of each column's
    largest entry, in f64, at every loss the kernel takes, with one
    sqrt_info or one an observation, either slot order and any chunk
    count; and the cost-only pass its cost.  Where the plan takes the
    kernel, its route (the twin over the plan's chunks) gives the chunked
    path's bits."""
    g = _port_bal(BAL_LOSSES[loss], per_obs_info=info == "per_observation")
    if order == "landmark_first":
        g = landmark_first(g)
    plan = tsl.prepare_large_ba(g, n_chunks)
    chunked = dataclasses.replace(plan, bal=False)
    cost, rows = tsl._obs_rows(chunked, plan.poses, plan.lms)
    t_cost, t_rows = cuda_ops.bal_rows_plain(*_bal_args(plan), plan.loss)
    _assert_rows_close(t_rows, rows, 1e-12)
    _assert_rows_close(t_cost[:, None], cost[:, None], 1e-12)
    only, none = cuda_ops.bal_rows_plain(*_bal_args(plan), plan.loss, rows=False)
    assert none is None and torch.equal(only, t_cost)
    np.testing.assert_allclose(float(tsl._obs_cost(chunked, plan.poses, plan.lms)), float(t_cost.sum()), rtol=1e-12)
    if plan.bal:
        r_cost, r_rows = tsl._obs_rows(plan, plan.poses, plan.lms)
        assert torch.equal(r_cost, cost) and torch.equal(r_rows, rows)
        assert torch.equal(tsl._obs_cost(plan, plan.poses, plan.lms), tsl._obs_cost(chunked, plan.poses, plan.lms))


BAL_ROUTES = {
    # graph, whether its plan takes bal_rows
    "bal": (lambda: _port_bal(), True),
    "bal_cauchy_per_obs": (lambda: _port_bal(CauchyLoss(2.0), per_obs_info=True), True),
    "bal_student_t_scale_estimated": (lambda: _port_bal(TDistributionLoss(5.0)), False),
    "bal_landmark_first": (lambda: landmark_first(_port_bal()), False),
    "stereo": (lambda: graphs("stereo")[1], False),
    "stereo_cauchy": (lambda: graphs("stereo_cauchy")[1], False),
}


@pytest.mark.parametrize("speculative", [True, False])
@pytest.mark.parametrize("name", sorted(BAL_ROUTES))
def test_bal_rows_route(name, speculative):
    """A ``reprojection_bal`` plan whose loss ``kernel_loss`` takes
    linearizes and costs its observations through ``bal_rows`` (here its
    twin), one call a linearization or cost-only pass; any other plan (a
    ``reprojection`` plan, a loss that re-estimates its scale, another
    kind) never does."""
    make, routed = BAL_ROUTES[name]
    g = make()
    plan = tsl.prepare_large_ba(g, 4)
    assert plan.bal == routed
    cuda_ops.reset_launches()
    calls = {"lin": 0, "cost": 0}
    linearize, cost = tsl._linearize, tsl._cost

    def counted(what, fn):
        def call(*a):
            calls[what] += 1
            return fn(*a)
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsl, "_linearize", counted("lin", linearize))
        mp.setattr(tsl, "_cost", counted("cost", cost))
        _, chi2, hist = tsl.solve_schur_large(g, tlm.Options(method="lm", max_iters=4), plan=plan,
                                              speculative=speculative)
    assert chi2 < hist[0] and calls["lin"] > 1 and (calls["cost"] > 0) == (not speculative)
    assert cuda_ops.LAUNCHES["bal_rows_plain"] == (calls["lin"] + calls["cost"] if routed else 0)
    assert cuda_ops.LAUNCHES["bal_rows"] == 0


def test_bal_rows_refuses_what_the_kernel_does_not_take():
    """The wrapper raises on a loss the kernel does not evaluate and on
    arguments of another type or shape, on the CPU as on the card."""
    plan = tsl.prepare_large_ba(_port_bal(), 4)
    args = _bal_args(plan)
    with pytest.raises(ValueError, match="does not evaluate"):
        cuda_ops.bal_rows(*args, TDistributionLoss(5.0))
    with pytest.raises(TypeError, match="obs"):
        cuda_ops.bal_rows(*args[:4], args[4].float(), *args[5:], L2Loss())
    with pytest.raises(ValueError, match="sqrt_info"):
        cuda_ops.bal_rows(*args[:8], args[8].reshape(1, 2, 2), args[9], L2Loss())
    with pytest.raises(TypeError, match="cam_idx"):
        cuda_ops.bal_rows(*args[:2], args[2].int(), *args[3:], L2Loss())
