"""Graduated non-convexity of the torch port (``solver/gnc.py``) against the
JAX reference, in f64 on the CPU, on pose graphs with planted wrong loop
closures (``synth.with_outliers``).

Tolerances: the surrogate weight functions 1e-14 relative; ``solve_gnc``
the same outer iteration count, identical inlier masks, weights within
1e-9 (identical where binary), chi2 1e-8 relative; the ELL assembly with
weights of exactly 0 (TLS rejects) finite and within 1e-10 of the
reference's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import to_port

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import bcsr as jbcsr
from pyslam_tpu.solver import gnc as jgnc
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu_torch.solver import bcsr as tbcsr
from pyslam_tpu_torch.solver import gnc as tgnc
from pyslam_tpu_torch.solver import lm as tlm
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

OPTS = dict(method="lm", max_iters=30, min_cost_decrease=0.999)


@pytest.mark.parametrize("fn", ["_tls_weights", "_gm_weights"])
def test_surrogate_weights_match_reference(fn):
    rng = np.random.default_rng(0)
    r2 = np.concatenate([10.0 ** rng.uniform(-6, 4, 200), [0.0, 1e-40]])
    for mu, c2 in ((1e-4, 5.99), (0.37, 12.59), (3.0, 5.99), (40.0, 1.0)):
        ref = np.asarray(getattr(jgnc, fn)(jnp.asarray(r2), mu, c2))
        out = getattr(tgnc, fn)(torch.from_numpy(r2), mu, c2).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-14, atol=0)


def _poisoned(kind):
    if kind == "se2":
        data = jsynth.se2_loop(n_poses=60, n_loops=8, seed=0)
    else:
        data = jsynth.se3_sphere(n_poses=40, n_loops=8, seed=6)
    return jsynth.with_outliers(data, 4, magnitude=2.0, seed=1)


CASES = {
    "se2_tls": ("se2", dict()),
    "se2_gm": ("se2", dict(surrogate="gm")),
    "se3_tls_ell": ("se3", dict(solve_fn="ell")),
}


@pytest.fixture(scope="module")
def reference_gnc():
    out = {}
    for name, (kind, kw) in CASES.items():
        data, planted = _poisoned(kind)
        g = jbuild.pose_graph(data, dtype=jnp.float64)
        if kw.get("solve_fn") == "ell":
            kw = dict(kw, solve_fn=jbcsr.solve_ell)
        out[name] = (g, planted, jgnc.solve_gnc(g, jlm.Options(**OPTS), **kw))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_gnc_matches_reference(name, reference_gnc):
    jg, planted, (js, ji) = reference_gnc[name]
    kw = dict(CASES[name][1])
    if kw.get("solve_fn") == "ell":
        kw["solve_fn"] = tbcsr.solve_ell
    ts, ti = tgnc.solve_gnc(to_port(jg), tlm.Options(**OPTS), **kw)
    assert ti.outer_iters == ji.outer_iters
    assert len(ti.weights) == len(ji.weights) == 1
    w, w_ref = ti.weights[0], np.asarray(ji.weights[0])
    binary = (w_ref == 0.0) | (w_ref == 1.0)
    np.testing.assert_array_equal(w[binary], w_ref[binary])
    np.testing.assert_allclose(w, w_ref, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ti.inlier_masks[0], np.asarray(ji.inlier_masks[0]))
    np.testing.assert_allclose(ti.chi2, float(ji.chi2), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(ti.mu_history), np.asarray(ji.mu_history), rtol=1e-12)
    np.testing.assert_allclose(ts.blocks["poses"].values.numpy(), np.asarray(js.blocks["poses"].values), rtol=0,
                               atol=1e-6)
    # the returned graph carries the final weights under L2
    assert type(ts.batches[0].loss).__name__ == "L2Loss"
    np.testing.assert_array_equal(ts.batches[0].weight.numpy(), w)
    # a planted edge may be quasi-consistent (the reference's own tests allow
    # one survivor)
    assert ti.inlier_masks[0][planted].sum() <= 1


def test_nothing_to_robustify_raises():
    data, _ = _poisoned("se2")
    with pytest.raises(ValueError, match="robustify"):
        tgnc.solve_gnc(to_port(jbuild.pose_graph(data, dtype=jnp.float64)), robustify=[])


@pytest.mark.parametrize("kind", ["se2", "se3"])
def test_zero_weights_in_the_ell_assembly(kind):
    """TLS rejects are weights of exactly 0: the ELL assembly (SE(3): the
    ``ell_assemble`` route; SE(2): the general route) stays finite and
    counts only the weighted factors in chi2, as the reference's does."""
    data, planted = _poisoned(kind)
    jg = jbuild.pose_graph(data, dtype=jnp.float64)
    w = np.ones(len(planted))
    w[planted] = 0.0
    w[:3] = 0.0
    jg = dataclasses.replace(jg, batches=[dataclasses.replace(jg.batches[0], weight=jnp.asarray(w))])
    tg = to_port(jg)
    assert (tbcsr.ell_assemble_batches(tg) is not None) == (kind == "se3")
    plan = tbcsr.build_ell_direct(tg)
    He, g, chi2 = tbcsr.assemble_ell(tg, tbcsr.ell_device_plan(plan, torch.device("cpu")))
    He_j, g_j, chi2_j = jbcsr.assemble_ell(jg, jbcsr.build_ell_direct(jg))
    assert torch.isfinite(He).all() and torch.isfinite(g).all()
    for a, b in ((He, He_j), (g, g_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10 * np.abs(np.asarray(b)).max())
    np.testing.assert_allclose(chi2.item(), float(chi2_j), rtol=1e-10)
    r, _ = tg.batches[0].evaluate(tg.blocks, compute_jacobians=False)
    live = tg.batches[0].loss.loss(r)[torch.from_numpy(w > 0)]
    np.testing.assert_allclose(chi2.item(), live.sum().item(), rtol=1e-10)
