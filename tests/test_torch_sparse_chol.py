"""The multifrontal sparse Cholesky of the torch port
(``solver/sparse_chol.py``) against the JAX reference, in f64 on the CPU,
on graphs built by the reference's builders from numpy seeds and carried
across with ``graph_from_numpy``.

Tolerances:
  * the plan (nested dissection, waves, gather tables): identical arrays;
  * one damped linear solve: dx within 1e-10 of its largest entry of the
    JAX dx (both eliminate in the same order; the sums of the forward
    solve run in another order), and within 1e-8 of a dense numpy solve;
  * ``solve_sparse_chol``: the same iteration count, status and accept
    sequence as the JAX solve, chi2 within 1e-10 relative, poses within
    1e-8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import assert_rel, to_port

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import bcsr as jbcsr
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu.solver import sparse_chol as jsc
from pyslam_tpu_torch.solver import assemble as tas
from pyslam_tpu_torch.solver import bcsr as tbcsr
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver import sparse_chol as tsc
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


GRAPHS = {
    "se2_loop_60": lambda: jbuild.pose_graph(jsynth.se2_loop(n_poses=60, n_loops=10, seed=3), dtype=F64),
    "se2_loop_40": lambda: jbuild.pose_graph(jsynth.se2_loop(n_poses=40, n_loops=6, seed=9), dtype=F64),
    # SE(3): assemble_ell goes to ell_assemble (its plain version here)
    "se3_sphere_150": lambda: jbuild.pose_graph(jsynth.se3_sphere(n_poses=150, seed=1), dtype=F64),
    "se2_manhattan_600": lambda: jbuild.pose_graph(jsynth.se2_manhattan(n_poses=600, seed=4), dtype=F64),
}

# (graph, leaf size) of the linear-solve checks; leaf 1000 is one dense leaf
CASES = [("se2_loop_60", 8), ("se3_sphere_150", 16), ("se2_loop_40", 4), ("se2_loop_40", 32), ("se2_loop_40", 1000)]


@functools.cache
def graphs(name):
    jg = GRAPHS[name]()
    return jg, to_port(jg)


@functools.cache
def plans(name, leaf_size):
    jg, tg = graphs(name)
    return jsc.build_chol_plan(jg, leaf_size=leaf_size), tsc.build_chol_plan(tg, leaf_size=leaf_size)


@pytest.mark.parametrize("name,leaf_size", CASES)
def test_plan_is_the_reference_plan(name, leaf_size):
    jp, tp = plans(name, leaf_size)
    assert (tp.nb, tp.d, tp.K, tp.pool_total) == (jp.nb, jp.d, jp.K, jp.pool_total)
    for a, b in ((jp.ell.cols, tp.ell.cols), (jp.ell.valid, tp.ell.valid)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert len(tp.waves) == len(jp.waves) > 0
    for wj, wt in zip(jp.waves, tp.waves):
        assert tuple(wt[:3]) == tuple(wj[:3])  # kpad, bpad, N
        for a, b in zip(wj[3:], wt[3:]):
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)


def _linear_system(name, leaf_size, lam=1e-3):
    jg, tg = graphs(name)
    jp, tp = plans(name, leaf_size)
    He, g, _ = tbcsr.assemble_ell(tg, tbcsr.ell_device_plan(tp.ell, "cpu"))
    return jg, tg, jp, tp, He, g, lam


@pytest.mark.parametrize("name,leaf_size", CASES)
def test_linear_solve_matches_reference_and_dense(name, leaf_size):
    jg, tg, jp, tp, He, g, lam = _linear_system(name, leaf_size)
    reset_launches()
    dx = tsc.sparse_chol_solve(tp, He, g, torch.tensor(lam, dtype=torch.float64), tlm.Options(method="lm"))
    # the forward solve's sums go through slot_reduce, one a wave with a real boundary
    waves = tsc._device_waves(tp, "cpu")
    assert LAUNCHES["slot_reduce_plain"] == sum(1 for w in waves if w.fwd_dest.numel())

    jsc._device_waves(jp)  # the reference caches its tables outside the trace
    He_j, g_j, _ = jax.jit(lambda gg: jbcsr.assemble_ell(gg, jp.ell))(jg)
    dx_j = jax.jit(lambda H, b, l: jsc.sparse_chol_solve(jp, H, b, l, jlm.Options(method="lm")))(
        He_j, g_j, jnp.asarray(lam, F64))
    assert_rel(dx, dx_j, 1e-10)

    H, gd, _ = tas.assemble_dense(tg)
    H = tas.unit_diag_where_dead(H).numpy()
    Hd = H + lam * np.diag(np.maximum(np.diag(H), 1e-12))
    np.testing.assert_allclose(dx.numpy(), np.linalg.solve(Hd, gd.numpy()), rtol=1e-8, atol=1e-9)


def test_linear_solve_leaves_He_alone_and_gn_is_undamped():
    jg, tg, jp, tp, He, g, lam = _linear_system("se2_loop_60", 8)
    before = He.clone()
    dx_gn = tsc.sparse_chol_solve(tp, He, g, torch.tensor(lam, dtype=torch.float64), tlm.Options(method="gn"))
    assert torch.equal(He, before)
    H, gd, _ = tas.assemble_dense(tg)
    np.testing.assert_allclose(dx_gn.numpy(), np.linalg.solve(tas.unit_diag_where_dead(H).numpy(), gd.numpy()),
                               rtol=1e-8, atol=1e-9)


def test_constant_poses_are_inert():
    data = jsynth.se2_loop(n_poses=30, n_loops=4, seed=5)
    tg = to_port(jbuild.pose_graph(data, dtype=F64))
    const = tg.blocks["poses"].const_mask
    assert const[0]
    plan = tsc.build_chol_plan(tg, leaf_size=8)
    He, g, _ = tbcsr.assemble_ell(tg, tbcsr.ell_device_plan(plan.ell, "cpu"))
    dx = tsc.sparse_chol_solve(plan, He, g, torch.tensor(1e-3, dtype=torch.float64), tlm.Options(method="lm"))
    assert torch.all(dx.reshape(-1, 3)[const] == 0.0)


def test_failed_factorization_gives_nan_and_the_step_is_rejected():
    """An indefinite diagonal block makes its wave's Cholesky fail: NaN
    blocks (no exception, no host read), a NaN step, and an LM iteration
    that rejects it and goes on."""
    jg, tg, jp, tp, He, g, lam = _linear_system("se2_loop_60", 8)
    bad = He.clone()
    bad[17, 0] = -torch.eye(3, dtype=torch.float64)
    dx = tsc.sparse_chol_solve(tp, bad, g, torch.tensor(0.0, dtype=torch.float64), tlm.Options(method="gn"))
    assert torch.isnan(dx).any()
    assert not torch.isnan(tsc.sparse_chol_solve(tp, He, g, torch.tensor(0.0, dtype=torch.float64),
                                                 tlm.Options(method="gn"))).any()

    dplan = tbcsr.ell_device_plan(tp.ell, "cpu")
    calls = []

    def first_step_fails(H, b, lam_, opt):
        calls.append(1)
        return tsc.sparse_chol_solve(tp, bad if len(calls) == 1 else H, b, lam_, opt)

    opt = tlm.Options(method="lm", max_iters=10)
    solved, info = tlm.solve(tg, opt, assemble_fn=lambda gg: tbcsr.assemble_ell(gg, dplan), solve_fn=first_step_fails)
    assert info.accepted.tolist()[:2] == [False, True]
    assert torch.isnan(info.update_norms[0]) and torch.isfinite(info.update_norms[1])
    assert info.lambda_history[1].item() == pytest.approx(1e-3)  # raised once by the rejection
    assert torch.isfinite(solved.blocks["poses"].values).all()


@pytest.mark.parametrize("name,method,max_iters", [("se2_manhattan_600", "lm", 40), ("se2_loop_60", "gn", 20)])
def test_solve_sparse_chol_matches_reference(name, method, max_iters):
    """A stiff M3500-class graph (where PCG stalls) and a GN solve: the
    exact optimum, step for step."""
    jg, tg = graphs(name)
    kw = dict(method=method, max_iters=max_iters)
    jp = jsc.build_chol_plan(jg)
    # the reference caches its tables outside the trace: its solve keeps the
    # plan in a closure cache by structure, which a later reference solve of
    # this graph in the same process reuses
    jsc._device_waves(jp)
    js, ji = jsc.solve_sparse_chol(jg, jlm.Options(**kw), plan=jp)
    reset_host_reads()
    reset_launches()
    ts, ti = tsc.solve_sparse_chol(tg, tlm.Options(**kw))
    assert HOST_READS == {"pcg": 0, "lm": ti.iterations}
    assert LAUNCHES["slot_reduce_plain"] > 0 and LAUNCHES["slot_reduce"] == 0
    assert ti.iterations == int(ji.iterations) and ti.status == int(ji.status)
    np.testing.assert_array_equal(ti.accepted.numpy(), np.asarray(ji.accepted))
    np.testing.assert_allclose(ti.chi2.item(), float(ji.chi2), rtol=1e-10)
    np.testing.assert_allclose(ts.blocks["poses"].values.numpy(), np.asarray(js.blocks["poses"].values), atol=1e-8)
    # the dense path reaches the same optimum
    _, di = tlm.solve(tg, tlm.Options(**kw))
    np.testing.assert_allclose(ti.chi2.item(), di.chi2.item(), rtol=1e-9)


def test_solve_sparse_chol_reuses_the_device_plan_and_repeats():
    _, tg = graphs("se2_loop_40")
    opts = tlm.Options(method="lm", max_iters=10)
    _, i1 = tsc.solve_sparse_chol(tg, opts)
    n = len(tsc._DEVICE_PLANS)
    plan = tsc.build_chol_plan(tg)
    _, i2 = tsc.solve_sparse_chol(tg, opts, plan=plan)
    assert len(tsc._DEVICE_PLANS) == n
    assert torch.equal(i1.chi2, i2.chi2)
    np.testing.assert_array_equal(i1.cost_history.numpy(), i2.cost_history.numpy())


# --------------------------------------------------------------------------
# Uncertainty over the factors: selected inverse, fill pairs, log det
# --------------------------------------------------------------------------

SWEEP_CASES = [("se2_loop_60", 8), ("se3_sphere_150", 16), ("se2_loop_40", 1000)]


def _factors(name, leaf_size):
    """Both packages' factors of the undamped ELL store of a graph."""
    jg, tg = graphs(name)
    jp, tp = plans(name, leaf_size)
    He, _, _ = tbcsr.assemble_ell(tg, tbcsr.ell_device_plan(tp.ell, "cpu"))
    jsc._device_waves(jp)  # the reference caches its tables outside the trace
    He_j, _, _ = jax.jit(lambda gg: jbcsr.assemble_ell(gg, jp.ell))(jg)
    return jp, tp, jax.jit(lambda H: jsc._factorize(jp, H))(He_j), tsc._factorize(tp, He), He


def _dense_inverse(tg):
    H, _, _ = tas.assemble_dense(tg)
    return np.linalg.inv(tas.unit_diag_where_dead(H).numpy())


@pytest.mark.parametrize("name,leaf_size", SWEEP_CASES)
def test_selected_inverse_matches_reference_and_dense(name, leaf_size):
    """Every diagonal block of H^-1 from the sweep: within 1e-10 of the
    reference's sweep and of a dense inverse (relative to the largest
    entry; the same eliminations, sums in another order)."""
    jp, tp, jf, tf, _ = _factors(name, leaf_size)
    ours = tsc.selected_inverse_marginals(tp, tf)
    ref = jax.jit(lambda f: jsc.selected_inverse_marginals(jp, f))(jf)
    assert_rel(ours, ref, 1e-10)
    d = tp.d
    Sig = _dense_inverse(graphs(name)[1])
    dense = np.stack([Sig[i * d:(i + 1) * d, i * d:(i + 1) * d] for i in range(tp.nb)])
    assert_rel(ours, dense, 1e-10)


def test_selected_inverse_pairs_with_swapped_extractions():
    """In-fill cross blocks from the same sweep, in either orientation (a
    swapped extraction is transposed back), against the reference and the
    dense inverse."""
    name, leaf_size = "se2_loop_60", 8
    jp, tp, jf, tf, _ = _factors(name, leaf_size)
    tg = graphs(name)[1]
    pairs = [(5, 6), (6, 5), (20, 21), (40, 41), (10, 10), (0, 1)]
    located = tsc.locate_fill_pairs(tp, pairs)
    assert located == jsc.locate_fill_pairs(jp, pairs)
    assert {sw for *_, sw in located} == {False, True}
    diag, blocks = tsc.selected_inverse_marginals(tp, tf, pairs=pairs)
    jdiag, jblocks = jax.jit(lambda f: jsc.selected_inverse_marginals(jp, f, pairs=pairs))(jf)
    assert_rel(diag, jdiag, 1e-10)
    assert_rel(blocks, jblocks, 1e-10)
    assert torch.equal(diag, tsc.selected_inverse_marginals(tp, tf))  # the pairs change nothing else
    Sig = _dense_inverse(tg)
    for (u, v), B in zip(pairs, blocks):
        assert_rel(B, Sig[3 * u:3 * u + 3, 3 * v:3 * v + 3], 1e-10)


def test_locate_fill_pairs_raises_out_of_range_and_out_of_fill():
    _, tp = plans("se2_loop_40", 4)
    for bad in [(0, 40), (-1, 5)]:
        with pytest.raises(ValueError, match="out of range"):
            tsc.locate_fill_pairs(tp, [bad])
    # a distant pair on a pure chain is outside the fill
    chain = to_port(jbuild.pose_graph(jsynth.se2_loop(n_poses=80, n_loops=0, seed=0), dtype=F64))
    plan = tsc.build_chol_plan(chain)
    with pytest.raises(ValueError, match="outside the factorization fill"):
        tsc.locate_fill_pairs(plan, [(1, 75)])
    assert tsc.locate_fill_pairs(plan, [(1, 2)])  # an odometry pair is always in it


@pytest.mark.parametrize("name,leaf_size", SWEEP_CASES)
def test_factor_logdet_matches_reference_and_slogdet(name, leaf_size):
    jp, tp, jf, tf, _ = _factors(name, leaf_size)
    ours = tsc.factor_logdet(tp, tf).item()
    np.testing.assert_allclose(ours, float(jsc.factor_logdet(jp, jf)), rtol=1e-12)
    H, _, _ = tas.assemble_dense(graphs(name)[1])
    sign, ref = np.linalg.slogdet(tas.unit_diag_where_dead(H).numpy())
    assert sign > 0
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


def test_hand_down_refuses_a_position_named_twice():
    """The sweep's hand-down is a plain indexed copy: a wave whose tables
    named one pool position twice would make the copy depend on the order
    of the writes, so the plan is refused when the first sweep takes its
    tables to the device."""
    tbl_l = np.zeros((1, 3, 3), np.int32)
    tbl_r = np.zeros((1, 3, 3), np.int32)
    tbl_l[0, 1, 1], tbl_l[0, 1, 2] = 7, 8
    src, pos = tsc._sigma_scatter(tbl_l, tbl_r)
    assert src.tolist() == [4, 5] and pos.tolist() == [7, 8]
    tbl_r[0, 2, 2] = 8  # the left child's position 8 again
    with pytest.raises(ValueError, match="named twice"):
        tsc._sigma_scatter(tbl_l, tbl_r)
    # and on real plans every hand-down position is named once (dump slot 0 left out)
    for name, leaf_size in CASES + [("se2_manhattan_600", 32)]:
        tp = plans(name, leaf_size)[1] if (name, leaf_size) in CASES else tsc.build_chol_plan(graphs(name)[1])
        for (_, sig_pos), wave in zip(tsc._sigma_scatters(tp, "cpu"), tp.waves):
            n_named = int((wave[7] > 0).sum() + (wave[8] > 0).sum())
            assert sig_pos.numel() == n_named == len(torch.unique(sig_pos))


@pytest.mark.parametrize("name,leaf_size", [("se2_loop_60", 8), ("se3_sphere_150", 16)])
def test_multi_column_solve_matches_single_columns_and_reference(name, leaf_size):
    """A block of m right-hand sides in one level-scheduled solve: each
    column as its own solve (1e-12 relative), the forward sums through the
    same plans, d*m wide; against the reference's vmap of its solve."""
    jp, tp, jf, tf, _ = _factors(name, leaf_size)
    D = tp.nb * tp.d
    B = np.random.default_rng(0).normal(size=(D, 5))
    reset_launches()
    X = tsc._solve_factored(tp, tf, torch.from_numpy(B))
    waves = tsc._device_waves(tp, "cpu")
    assert X.shape == (D, 5) and LAUNCHES["slot_reduce_plain"] == sum(1 for w in waves if w.fwd_dest.numel())
    for j in range(5):
        assert_rel(X[:, j], tsc._solve_factored(tp, tf, torch.from_numpy(B[:, j].copy())), 1e-12)
    ref = jax.jit(jax.vmap(lambda b: jsc._solve_factored(jp, jf, b), in_axes=1, out_axes=1))(jnp.asarray(B))
    assert_rel(X, ref, 1e-10)
