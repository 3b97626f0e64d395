"""``solve_ell`` and ``pcg_solve`` of the torch port against the JAX
reference, in f64 on the CPU, on the same problem and ``Options``: the
same LM/GN iteration count, stop code and accept/reject sequence, chi2
within 1e-8 relative and poses within 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import jax_graph, to_port

from pyslam_tpu.solver import bcsr as jb
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu.solver.linear import pcg_solve as j_pcg_solve
from pyslam_tpu_torch.solver import bcsr as tb
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver.linear import HOST_READS, pcg_solve, reset_host_reads
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

CASES = [
    ("l2", "lm", True),
    ("l2", "lm", False),
    ("l2", "gn", True),
    ("l2", "gn", False),
    ("robust_prior", "lm", True),
]


@pytest.mark.parametrize("graph,method,speculative", CASES)
def test_solve_ell_matches_reference(graph, method, speculative):
    jg = jax_graph(graph)
    kw = dict(method=method, max_iters=15, speculative=speculative)
    js, ji = jb.solve_ell(jg, jlm.Options(**kw))
    ts, ti = tb.solve_ell(to_port(jg), tlm.Options(**kw))

    assert ti.iterations == int(ji.iterations)
    assert ti.status == int(ji.status)
    np.testing.assert_array_equal(ti.accepted.numpy(), np.asarray(ji.accepted))
    np.testing.assert_allclose(ti.chi2.item(), float(ji.chi2), rtol=1e-8)
    hist_j, hist_t = np.asarray(ji.cost_history), ti.cost_history.numpy()
    np.testing.assert_array_equal(np.isnan(hist_t), np.isnan(hist_j))
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-8)
    np.testing.assert_allclose(
        ts.blocks["poses"].values.numpy(), np.asarray(js.blocks["poses"].values), rtol=0, atol=1e-6
    )


def test_host_reads_per_iteration():
    """One read per LM iteration, and one per CG stop test."""
    tg = to_port(jax_graph("l2"))
    reset_host_reads()
    _, info = tb.solve_ell(tg, tlm.Options(method="lm", max_iters=5))
    assert HOST_READS["lm"] == info.iterations
    assert HOST_READS["pcg"] >= info.iterations


@pytest.mark.parametrize("max_iters", [3, 500])
def test_pcg_matches_reference(max_iters):
    rng = np.random.default_rng(9)
    A = rng.normal(size=(40, 40))
    A = A @ A.T + 40 * np.eye(40)
    b = rng.normal(size=40)
    Minv = 1.0 / np.diag(A)
    xj, itj = j_pcg_solve(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b), precond=lambda r: jnp.asarray(Minv) * r,
        rtol=1e-10, max_iters=max_iters,
    )
    At, Mt = torch.from_numpy(A), torch.from_numpy(Minv)
    xt, itt = pcg_solve(lambda v: At @ v, torch.from_numpy(b), precond=lambda r: Mt * r,
                        rtol=1e-10, max_iters=max_iters)
    assert itt == int(itj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


def test_pcg_zero_rhs_takes_no_step():
    x, it = pcg_solve(lambda v: 2.0 * v, torch.zeros(5, dtype=torch.float64))
    assert it == 0 and not x.any()


def test_options_match_reference():
    jf = {f.name: f.default for f in dataclasses.fields(jlm.Options)}
    tf = {f.name: f.default for f in dataclasses.fields(tlm.Options)}
    assert jf == tf
    assert tlm.STATUS_NAMES == jlm.STATUS_NAMES
    assert tlm.SolveInfo._fields == jlm.SolveInfo._fields


@pytest.mark.parametrize("case", ["two_level"])
def test_unported_options_raise(case):
    """``precond="two_level"``, which once raised here, solves as the
    reference's does (``tests/test_torch_bcsr.py`` holds it case by case);
    what raises now is a name that is neither it nor ``"bj"``, which the
    reference would take for ``"bj"``."""
    jg = jax_graph("l2")
    tg = to_port(jg)
    kw = dict(pcg_rtol=1e-8, pcg_max_iters=600, coarse_size=16)
    ts, ti = tb.solve_ell(tg, tlm.Options(max_iters=15), precond=case, **kw)
    js, ji = jb.solve_ell(jg, jlm.Options(max_iters=15), precond=case, **kw)
    assert (ti.iterations, ti.status) == (int(ji.iterations), int(ji.status))
    np.testing.assert_allclose(ti.chi2.item(), float(ji.chi2), rtol=1e-9)
    with pytest.raises(ValueError, match="precond"):
        tb.solve_ell(tg, tlm.Options(), precond="ilu")


@pytest.mark.parametrize("graph,speculative", [("l2", True), ("robust_prior", False)])
def test_solve_ell_dogleg_matches_reference(graph, speculative):
    """Dogleg on the ELL path: its model evaluations go through the ELL
    matvec (``matvec_fn``), as in the reference."""
    jg = jax_graph(graph)
    kw = dict(method="dogleg", max_iters=15, speculative=speculative)
    js, ji = jb.solve_ell(jg, jlm.Options(**kw))
    ts, ti = tb.solve_ell(to_port(jg), tlm.Options(**kw))
    assert ti.iterations == int(ji.iterations)
    assert ti.status == int(ji.status)
    np.testing.assert_array_equal(ti.accepted.numpy(), np.asarray(ji.accepted))
    np.testing.assert_allclose(ti.chi2.item(), float(ji.chi2), rtol=1e-8)
    np.testing.assert_allclose(ti.lambda_history.numpy(), np.asarray(ji.lambda_history), rtol=1e-8)
    np.testing.assert_allclose(
        ts.blocks["poses"].values.numpy(), np.asarray(js.blocks["poses"].values), rtol=0, atol=1e-6
    )


def test_dense_default_path_matches_reference():
    """``solve`` with no linear path given runs the dense one, on SE(3)."""
    jg = jax_graph("l2")
    js, ji = jlm.solve(jg, jlm.Options(max_iters=10))
    ts, ti = tlm.solve(to_port(jg), tlm.Options(max_iters=10))
    assert (ti.iterations, ti.status) == (int(ji.iterations), int(ji.status))
    np.testing.assert_array_equal(ti.accepted.numpy(), np.asarray(ji.accepted))
    np.testing.assert_allclose(ti.chi2.item(), float(ji.chi2), rtol=1e-8)
    np.testing.assert_allclose(
        ts.blocks["poses"].values.numpy(), np.asarray(js.blocks["poses"].values), rtol=0, atol=1e-6
    )


def test_solution_stays_on_the_graph_device_and_dtype():
    tg = to_port(jax_graph("l2"), dtype=torch.float32)
    s, info = tb.solve_ell(tg, tlm.Options(max_iters=3))
    v = s.blocks["poses"].values
    assert v.dtype == torch.float32 and v.device.type == "cpu"
    assert info.chi2.dtype == torch.float32
    assert info.cost_history.shape == (4,) and info.lambda_history.shape == (3,)
    assert torch.isfinite(v).all()
