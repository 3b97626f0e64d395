"""The BCSR family (``BlockPattern`` ... ``solve_bcsr``) and
``solve_ell(precond="two_level")`` of the torch port against the JAX
reference (``pyslam_tpu/solver/bcsr.py``), in f64 on the CPU, on the same
numpy inputs (the reference's ``tests/test_bcsr.py`` graphs and the
parity tests' SE(3) sphere with priors, a padded one and a Cauchy loss).

Tolerances: the patterns (``build_pattern``, ``build_ell``,
``build_group_jacobi``, ``_coarse_groups``) are the reference's arrays;
``assemble_bcsr`` within 1e-12 of the reference's (relative to its
largest entry); the products and preconditioners within 1e-10 of the
dense matrix; whole solves the same LM iterations, stop code and accept
sequence, chi2 and cost history within 1e-9 relative, poses within 1e-8.
``schur_large._pcg(..., read_every=0, guard=False)``, the loop of
``solve_bcsr`` and two-level ``solve_ell``, gives ``pcg_solve``'s iterates
and counts with no host read.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import jax_graph, to_port

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import bcsr as jb
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu.solver.linear import pcg_solve as j_pcg_solve
from pyslam_tpu_torch.solver import bcsr as tb
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver.assemble import assemble_dense
from pyslam_tpu_torch.solver.cuda_ops import LAUNCHES, reset_launches
from pyslam_tpu_torch.solver import schur_large as tsl
from pyslam_tpu_torch.solver.linear import HOST_READS, pcg_solve, reset_host_reads
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64


def _loop(seed=3):
    return jbuild.pose_graph(jsynth.se2_loop(n_poses=30, n_loops=5, seed=seed), dtype=F64)


def _frozen(g):
    """Poses 0 and 7 constant."""
    pb = g.blocks["poses"]
    blocks = dict(g.blocks)
    blocks["poses"] = dataclasses.replace(pb, const_mask=pb.const_mask.at[7].set(True))
    return type(g)(blocks, g.batches)


GRAPHS = {
    "se2_loop": lambda: _loop(),
    "se2_loop_seed9": lambda: _loop(seed=9),
    "se3_sphere": lambda: jax_graph("l2"),
    "se3_sphere_coarse4": lambda: jax_graph("l2"),
    "robust_prior": lambda: jax_graph("robust_prior"),
    "frozen": lambda: _frozen(_loop()),
}
_CACHE = {}


def graphs(name):
    if name not in _CACHE:
        jg = GRAPHS[name]()
        _CACHE[name] = (jg, to_port(jg))
    return _CACHE[name]


def dense(tg):
    return assemble_dense(tg)[0].numpy()


def assert_close(out, ref, rel):
    ref = np.asarray(ref)
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


# --------------------------------------------------------------------------
# Patterns: the reference's arrays
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_pattern_gives_the_reference_arrays(name):
    jg, tg = graphs(name)
    jp, tp = jb.build_pattern(jg), tb.build_pattern(tg)
    assert (tp.block_name, tp.nb, tp.d, tp.nnzb) == (jp.block_name, jp.nb, jp.d, jp.nnzb)
    for f in ("rows", "cols", "diag_pos"):
        a, b = getattr(tp, f), getattr(jp, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(tp.maps) == len(jp.maps)
    for t_entries, j_entries in zip(tp.maps, jp.maps):
        assert len(t_entries) == len(j_entries)
        for (ta, tb_, tpos, ttr), (ja, jb_, jpos, jtr) in zip(t_entries, j_entries):
            assert (ta, tb_) == (ja, jb_) and tpos.dtype == jpos.dtype
            np.testing.assert_array_equal(tpos, jpos)
            np.testing.assert_array_equal(ttr, jtr)


@pytest.mark.parametrize("name", ["se2_loop", "se3_sphere", "robust_prior"])
def test_build_ell_gives_the_reference_arrays(name):
    jg, tg = graphs(name)
    je, te = jb.build_ell(jb.build_pattern(jg)), tb.build_ell(tb.build_pattern(tg))
    assert (te.nb, te.d, te.K) == (je.nb, je.d, je.K)
    for f in ("cols", "sel", "trans", "valid"):
        a, b = getattr(te, f), getattr(je, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("G", [3, 8, 30])
@pytest.mark.parametrize("name", ["se2_loop", "se3_sphere"])
def test_build_group_jacobi_gives_the_reference_arrays(name, G):
    jg, tg = graphs(name)
    jgj, tgj = jb.build_group_jacobi(jb.build_pattern(jg), G), tb.build_group_jacobi(tb.build_pattern(tg), G)
    assert (tgj.ng, tgj.G, tgj.d, tgj.nb_pad) == (jgj.ng, jgj.G, jgj.d, jgj.nb_pad)
    for f in ("sel", "trans", "valid"):
        a, b = getattr(tgj, f), getattr(jgj, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_build_pattern_refuses_what_the_reference_asserts_or_clamps():
    from pyslam_tpu_torch.graph import FactorGraph

    _, tg = graphs("se2_loop")
    fb = tg.batches[0]
    bad = FactorGraph(tg.blocks, [dataclasses.replace(fb, indices=(fb.indices[0], fb.indices[1] + 1))])
    with pytest.raises(ValueError, match="out of range"):
        tb.build_pattern(bad)
    from test_torch_schur_large import graphs as ba_graphs

    with pytest.raises(ValueError, match="single variable block"):
        tb.build_pattern(ba_graphs("stereo")[1], "poses")


# --------------------------------------------------------------------------
# Assembly, products, preconditioners
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_assemble_bcsr_matches_reference(name):
    jg, tg = graphs(name)
    Hj, gj, cj = jb.assemble_bcsr(jg, jb.build_pattern(jg))
    Ht, gt, ct = tb.assemble_bcsr(tg, tb.build_pattern(tg))
    assert_close(Ht, Hj, 1e-12)
    assert_close(gt, gj, 1e-12)
    np.testing.assert_allclose(ct.item(), float(cj), rtol=1e-12)


def _densify(H, pattern):
    nb, d = pattern.nb, pattern.d
    Hd = np.zeros((nb * d, nb * d))
    for p, (r, c) in enumerate(zip(pattern.rows, pattern.cols)):
        Hd[r * d:(r + 1) * d, c * d:(c + 1) * d] += H[p]
        if r != c:
            Hd[c * d:(c + 1) * d, r * d:(r + 1) * d] += H[p].T
    return Hd


@pytest.mark.parametrize("name", ["se2_loop", "robust_prior", "frozen"])
def test_products_match_the_dense_matrix(name):
    """``assemble_bcsr`` densified is ``assemble_dense``'s H; ``bcsr_matvec``
    and ``ell_matvec`` over ``ell_blocks`` are its products."""
    _, tg = graphs(name)
    pattern = tb.build_pattern(tg)
    H, g, _ = tb.assemble_bcsr(tg, pattern)
    Hd = dense(tg)
    assert_close(_densify(H.numpy(), pattern), Hd, 1e-12)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=Hd.shape[0]))
    ref = Hd @ x.numpy()
    assert_close(tb.bcsr_matvec(H, pattern, x), ref, 1e-12)
    ell = tb.build_ell(pattern)
    He = tb.ell_blocks(H, ell)
    reset_launches()
    assert_close(tb.ell_matvec(He, ell, x), ref, 1e-12)
    assert LAUNCHES["ell_matvec_plain"] == 1  # the kernel's plain version on the CPU
    pad = ell.valid == 0
    assert not He.numpy()[pad].any() and not ell.cols[pad].any()  # padding: zero blocks at column 0


@pytest.mark.parametrize("name", ["se2_loop", "se3_sphere"])
def test_block_jacobi_and_damping_match_reference(name):
    jg, tg = graphs(name)
    jp, tp = jb.build_pattern(jg), tb.build_pattern(tg)
    Hj = jb.assemble_bcsr(jg, jp)[0]
    Ht = tb.assemble_bcsr(tg, tp)[0]
    assert_close(tb.damp_blocks(Ht, tp, 0.3), jb.damp_blocks(Hj, jp, 0.3), 1e-12)
    assert_close(tb.block_jacobi_inv(Ht, tp), jb.block_jacobi_inv(Hj, jp), 1e-10)


@pytest.mark.parametrize("G", [8, 30])
def test_group_jacobi_apply(G):
    """One group over every pose is the dense solve (the reference's
    ``test_exact_when_group_covers_graph``); padded groups stay finite and
    positive; both match the reference's factor and application."""
    jg, tg = graphs("se2_loop")
    jp, tp = jb.build_pattern(jg), tb.build_pattern(tg)
    Ht, Hj = tb.assemble_bcsr(tg, tp)[0], jb.assemble_bcsr(jg, jp)[0]
    tgj, jgj = tb.build_group_jacobi(tp, G), jb.build_group_jacobi(jp, G)
    L = tb.group_jacobi_factor(Ht, tgj)
    assert_close(L, jb.group_jacobi_factor(Hj, jgj), 1e-10)
    r = torch.from_numpy(np.random.default_rng(2).normal(size=tp.nb * tp.d))
    z = tb.group_jacobi_apply(L, tgj, r)
    assert_close(z, jb.group_jacobi_apply(jb.group_jacobi_factor(Hj, jgj), jgj, jnp.asarray(r.numpy())), 1e-10)
    if G == tp.nb:
        assert_close(z, np.linalg.solve(dense(tg), r.numpy()), 1e-10)
    assert torch.isfinite(z).all() and float(z @ r) > 0


def test_failed_factorizations_give_nan():
    _, tg = graphs("se2_loop")
    tp = tb.build_pattern(tg)
    H = tb.assemble_bcsr(tg, tp)[0]
    H[tp.diag_pos[4]] = -torch.eye(3, dtype=H.dtype)
    assert torch.isnan(tb.block_jacobi_inv(H, tp)[4]).all() and torch.isfinite(tb.block_jacobi_inv(H, tp)[3]).all()
    assert torch.isnan(tb.group_jacobi_factor(H, tb.build_group_jacobi(tp, 8))[0]).all()


# --------------------------------------------------------------------------
# The device PCG loop
# --------------------------------------------------------------------------


def _unguarded(matvec, b, precond=lambda r: r, rtol=1e-6, max_iters=500):
    return tsl._pcg(matvec, precond, b, rtol, max_iters, read_every=0, guard=False)


@pytest.mark.parametrize("max_iters", [3, 500])
def test_unguarded_pcg_gives_pcg_solve_iterates(max_iters):
    rng = np.random.default_rng(9)
    A = rng.normal(size=(40, 40))
    A = A @ A.T + 40 * np.eye(40)
    b = rng.normal(size=40)
    Minv = 1.0 / np.diag(A)
    At, Mt, bt = torch.from_numpy(A), torch.from_numpy(Minv), torch.from_numpy(b)
    xj, itj = j_pcg_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), precond=lambda r: jnp.asarray(Minv) * r,
                          rtol=1e-10, max_iters=max_iters)
    xh, ith = pcg_solve(lambda v: At @ v, bt, precond=lambda r: Mt * r, rtol=1e-10, max_iters=max_iters)
    reset_host_reads()
    xd, itd = _unguarded(lambda v: At @ v, bt, precond=lambda r: Mt * r, rtol=1e-10, max_iters=max_iters)
    assert HOST_READS["pcg"] == 0
    assert int(itd) == ith == int(itj)
    np.testing.assert_array_equal(xd.numpy(), xh.numpy())
    np.testing.assert_allclose(xd.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


def test_unguarded_pcg_zero_rhs_nan_and_breakdown():
    x, it = _unguarded(lambda v: 2.0 * v, torch.zeros(5, dtype=torch.float64), max_iters=4)
    assert int(it) == 0 and not x.any()
    # x0 = 0 and r0 = b (no product): a NaN product spoils the first step,
    # after which the stop test fails and the LM loop rejects the step
    x, it = _unguarded(lambda v: v * float("nan"), torch.ones(5, dtype=torch.float64), max_iters=4)
    assert int(it) == 1 and torch.isnan(x).all()
    # pAp = 0: the guarded loop keeps x; unguarded, as pcg_solve, it does not
    b = torch.ones(5, dtype=torch.float64)
    x, it = _unguarded(lambda v: 0.0 * v, b, max_iters=4)
    xh, ith = pcg_solve(lambda v: 0.0 * v, b, max_iters=4)
    assert int(it) == ith == 1 and not torch.isfinite(x).any() and not torch.isfinite(xh).any()
    xg, _ = tsl._pcg(lambda v: 0.0 * v, lambda r: r, b, 1e-6, 4, read_every=0)
    assert not xg.any()


# --------------------------------------------------------------------------
# Solves against the reference
# --------------------------------------------------------------------------


def assert_same_solve(j, t, rel=1e-9, state=1e-8):
    (js, ji), (ts, ti) = j, t
    assert (ti.iterations, ti.status) == (int(ji.iterations), int(ji.status))
    np.testing.assert_array_equal(ti.accepted.numpy(), np.asarray(ji.accepted))
    np.testing.assert_allclose(ti.chi2.item(), float(ji.chi2), rtol=rel)
    hj, ht = np.asarray(ji.cost_history), ti.cost_history.numpy()
    np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
    np.testing.assert_allclose(ht, hj, rtol=rel)
    np.testing.assert_allclose(ts.blocks["poses"].values.numpy(), np.asarray(js.blocks["poses"].values), rtol=0,
                               atol=state)


SOLVE_BCSR = [
    ("se2_loop_seed9", "lm", "ell", 1),
    ("se2_loop_seed9", "lm", "bcsr", 1),
    ("se2_loop_seed9", "lm", "ell", 8),
    ("se2_loop_seed9", "lm", "bcsr", 8),
    ("se2_loop_seed9", "gn", "ell", 1),
    ("robust_prior", "lm", "ell", 1),
    ("robust_prior", "lm", "bcsr", 4),
    ("frozen", "lm", "ell", 3),
]


@pytest.mark.parametrize("name,method,spmv,group", SOLVE_BCSR)
def test_solve_bcsr_matches_reference(name, method, spmv, group):
    """Every (spmv, precond_group) combination, the reference's PCG
    defaults (1e-8 / 250)."""
    jg, tg = graphs(name)
    kw = dict(method=method, max_iters=15)
    j = jb.solve_bcsr(jg, jlm.Options(**kw), spmv=spmv, precond_group=group)
    reset_host_reads()
    reset_launches()
    tsl.reset_cg_iterations()
    t = tb.solve_bcsr(tg, tlm.Options(**kw), spmv=spmv, precond_group=group)
    assert_same_solve(j, t)
    assert HOST_READS["pcg"] == 0 and HOST_READS["lm"] == t[1].iterations
    its = tsl.cg_iterations()
    assert len(its) == t[1].iterations and all(0 < n <= 250 for n in its)
    products = LAUNCHES["ell_matvec_plain"]
    assert products == (len(its) * 250 if spmv == "ell" else 0)  # r0 = b, then the whole budget
    assert LAUNCHES["slot_reduce_plain"] >= 2 * t[1].iterations


def test_solve_bcsr_reaches_the_dense_optimum():
    """The reference's ``TestBCSRSolve::test_matches_dense_solve``."""
    _, tg = graphs("se2_loop_seed9")
    opts = tlm.Options(method="lm", max_iters=30)
    _, i_dense = tlm.solve(tg, opts)
    _, i_bcsr = tb.solve_bcsr(tg, opts, pcg_rtol=1e-12, pcg_max_iters=500)
    assert abs(i_dense.chi2.item() - i_bcsr.chi2.item()) / i_dense.chi2.item() < 1e-6


def test_solve_bcsr_refuses_dogleg_and_unknown_spmv():
    """As in the reference, dogleg needs a matvec_fn that solve_bcsr does
    not pass; an unknown ``spmv`` raises here (the reference takes it for
    'bcsr')."""
    _, tg = graphs("se2_loop")
    with pytest.raises(ValueError, match="dogleg"):
        tb.solve_bcsr(tg, tlm.Options(method="dogleg"))
    with pytest.raises(ValueError, match="spmv"):
        tb.solve_bcsr(tg, tlm.Options(), spmv="csr")


@pytest.mark.parametrize("name,coarse", [("se2_loop", 8), ("robust_prior", 16)])
def test_coarse_groups_are_the_reference_groups(name, coarse):
    jg, tg = graphs(name)
    jgrp, jG = jb._coarse_groups(jg, jb.build_ell_direct(jg), coarse)
    tgrp, tG = tb._coarse_groups(tg, tb.build_ell_direct(tg), coarse)
    assert tG == jG and tgrp.dtype == jgrp.dtype
    np.testing.assert_array_equal(tgrp, jgrp)
    assert (np.bincount(tgrp, minlength=tG) > 0).all()


# CG budgets the linear solves stop inside: a solve cut by its budget
# amplifies rounding (at rtol 1e-10 / 200 on 'robust_prior' the first
# step's poses part from the reference's by 2e-8), and one that stops at
# rtol 3e-6 can stop an iteration apart from it
TWO_LEVEL = [
    ("se2_loop_seed9", dict(method="lm", max_iters=15), dict(pcg_rtol=1e-10, pcg_max_iters=200, coarse_size=8)),
    ("se3_sphere", dict(method="lm", max_iters=15), dict(pcg_rtol=1e-8, pcg_max_iters=600, coarse_size=16)),
    ("se3_sphere_coarse4", dict(method="lm", max_iters=15), dict(pcg_rtol=1e-8, pcg_max_iters=600, coarse_size=4)),
    ("robust_prior", dict(method="lm", max_iters=15), dict(pcg_rtol=1e-8, pcg_max_iters=600, coarse_size=16)),
    ("se2_loop", dict(method="gn", max_iters=8), dict(coarse_size=4)),
]


@pytest.mark.parametrize("name,opts,kw", TWO_LEVEL)
def test_two_level_matches_reference(name, opts, kw):
    jg, tg = graphs(name)
    j = jb.solve_ell(jg, jlm.Options(**opts), precond="two_level", **kw)
    reset_host_reads()
    reset_launches()
    tsl.reset_cg_iterations()
    t = tb.solve_ell(tg, tlm.Options(**opts), precond="two_level", **kw)
    assert_same_solve(j, t)
    assert HOST_READS["pcg"] == 0 and LAUNCHES["ell_pcg_plain"] == 0 and LAUNCHES["ell_pcg"] == 0
    its = tsl.cg_iterations()
    budget = kw.get("pcg_max_iters", 120)
    assert len(its) == t[1].iterations and LAUNCHES["ell_matvec_plain"] == len(its) * budget
    # the coarse blocks and every r_c: one slot_reduce each
    assert LAUNCHES["slot_reduce_plain"] >= len(its) * (budget + 2)


def test_two_level_reaches_the_bj_optimum_in_fewer_iterations():
    """The reference's ``TestTwoLevelPrecond::test_matches_bj_solution``:
    the same optimum as block-Jacobi (1e-8); and on this loopy sphere the
    coarse level takes no more CG iterations a linear solve."""
    jg = jbuild.pose_graph(jsynth.se3_sphere(n_poses=300, seed=5), dtype=F64)
    tg = to_port(jg)
    opts = tlm.Options(method="lm", max_iters=20)
    _, i_bj = tb.solve_ell(tg, opts, pcg_rtol=1e-10, pcg_max_iters=500)
    tsl.reset_cg_iterations()
    _, i_tl = tb.solve_ell(tg, opts, pcg_rtol=1e-10, pcg_max_iters=500, precond="two_level", coarse_size=32)
    its = tsl.cg_iterations()
    np.testing.assert_allclose(i_tl.chi2.item(), i_bj.chi2.item(), rtol=1e-8)
    _, j_tl = jb.solve_ell(jg, jlm.Options(method="lm", max_iters=20), pcg_rtol=1e-10, pcg_max_iters=500,
                           precond="two_level", coarse_size=32)
    np.testing.assert_allclose(i_tl.chi2.item(), float(j_tl.chi2), rtol=1e-9)
    assert len(its) == i_tl.iterations and max(its) < 500
