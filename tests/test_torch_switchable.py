"""Switchable loop closures of the torch port (``between_se2_switch`` /
``between_se3_switch``, ``build.switchable_pose_graph``) against the JAX
reference, in f64 on the CPU.

Tolerances: residuals and Jacobians 1e-10; the built graphs the same
arrays; the dense H and g of a graph with 3-slot factors (including one
whose two pose slots name the same pose) 1e-10 relative; LM solves the
same iteration counts and stop codes, chi2 1e-8 relative, switch values
1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import to_port

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FACTOR_KERNELS as JK
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.lie import se2 as jse2
from pyslam_tpu.lie import se3 as jse3
from pyslam_tpu.solver import assemble as jassemble
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu_torch.graph import build as tbuild
from pyslam_tpu_torch.graph.core import FACTOR_KERNELS as TK
from pyslam_tpu_torch.io import g2o as tg2o
from pyslam_tpu_torch.io import synth as tsynth
from pyslam_tpu_torch.solver import assemble as tassemble
from pyslam_tpu_torch.solver import lm as tlm
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

CPU = dict(dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("ops,dof,kind", [(jse3, 6, "between_se3_switch"), (jse2, 3, "between_se2_switch")])
def test_switch_kernel_matches_reference(ops, dof, kind):
    rng = np.random.default_rng(3)
    F = 5
    T1 = np.asarray(ops.exp(jnp.asarray(rng.normal(size=(F, dof)))))
    T2 = np.asarray(ops.exp(jnp.asarray(rng.normal(size=(F, dof)))))
    s = rng.uniform(-0.2, 1.1, size=(F, 1))
    data = {
        "T_obs": np.asarray(ops.exp(jnp.asarray(rng.normal(size=(F, dof)) * 0.1))),
        "sqrt_info": np.stack([np.diag(rng.uniform(0.5, 2, dof)) for _ in range(F)]),
        "xi": rng.uniform(0.5, 2, size=F),
    }
    rj, jj = JK[kind]({k: jnp.asarray(v) for k, v in data.items()}, *(jnp.asarray(a) for a in (T1, T2, s)))
    rt, jt = TK[kind]({k: torch.tensor(v) for k, v in data.items()}, *(torch.tensor(a) for a in (T1, T2, s)))
    assert rt.shape == (F, dof + 1) and [J.shape for J in jt] == [(F, dof + 1, dof)] * 2 + [(F, dof + 1, 1)]
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-10)
    for a, b in zip(jt, jj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)


def test_prior_row_is_zero_with_the_switch_on():
    T = torch.eye(3, dtype=torch.float64)[None]
    data = {"T_obs": T.clone(), "sqrt_info": torch.eye(3, dtype=torch.float64)[None],
            "xi": torch.ones(1, dtype=torch.float64)}
    r, _ = TK["between_se2_switch"](data, T, T, torch.ones((1, 1), dtype=torch.float64), compute_jacobians=False)
    assert torch.equal(r, torch.zeros_like(r))


def _poisoned(dim, n_bad=3):
    """(the reference's data, the port's data, real loops, wrong loops)."""
    if dim == 2:
        make = dict(n_poses=60, n_loops=8, seed=0)
        jd, td = jsynth.se2_loop(**make), tsynth.se2_loop(**make)
    else:
        make = dict(n_poses=40, n_loops=8, seed=6)
        jd, td = jsynth.se3_sphere(**make), tsynth.se3_sphere(**make)
    jp, _ = jsynth.with_outliers(jd, n_bad, magnitude=2.0, seed=1)
    tp, _ = tsynth.with_outliers(td, n_bad, magnitude=2.0, seed=1)
    # the outlier measurements agree to rounding (each package's own exp):
    # give both packages the same bits
    tp = dataclasses.replace(tp, T_meas=np.asarray(jp.T_meas))
    n_real = int((np.abs(np.asarray(jd.edges_i) - np.asarray(jd.edges_j)) != 1).sum())
    return jp, tp, n_real, n_bad


def _same_graph(tg, jg):
    assert list(tg.blocks) == list(jg.blocks)
    for name, b in tg.blocks.items():
        jb = jg.blocks[name]
        assert b.kind == jb.kind
        np.testing.assert_array_equal(b.values.numpy(), np.asarray(jb.values))
        np.testing.assert_array_equal(b.const_mask.numpy(), np.asarray(jb.const_mask))
    assert len(tg.batches) == len(jg.batches)
    for fb, jfb in zip(tg.batches, jg.batches):
        assert (fb.kind, tuple(fb.slots)) == (jfb.kind, tuple(jfb.slots))
        for i, ji in zip(fb.indices, jfb.indices):
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert fb.data.keys() == jfb.data.keys()
        for k in fb.data:
            np.testing.assert_array_equal(fb.data[k].numpy(), np.asarray(jfb.data[k]))
        np.testing.assert_array_equal(fb.weight.numpy(), np.asarray(jfb.weight))


@pytest.mark.parametrize("dim", [2, 3])
def test_switchable_pose_graph_is_the_reference(dim):
    jp, tp, n_real, n_bad = _poisoned(dim)
    tg = tbuild.switchable_pose_graph(tp, xi=5.0, **CPU)
    _same_graph(tg, jbuild.switchable_pose_graph(jp, dtype=jnp.float64, xi=5.0))
    assert tg.blocks["switches"].values.shape == (n_real + n_bad, 1)
    # per-edge xi and s_init, and an explicit loop mask
    rng = np.random.default_rng(2)
    mask = np.abs(np.asarray(tp.edges_i) - np.asarray(tp.edges_j)) != 1
    mask[np.nonzero(mask)[0][:2]] = False
    kw = dict(xi=rng.uniform(2, 8, int(mask.sum())), s_init=rng.uniform(0.5, 1, int(mask.sum())), loop_mask=mask,
              init="gt", anchor_first=False)
    _same_graph(tbuild.switchable_pose_graph(tp, **kw, **CPU),
                jbuild.switchable_pose_graph(jp, dtype=jnp.float64, **kw))


def test_loop_free_graph_gets_the_placeholder_switch():
    data = tsynth.se2_loop(n_poses=12, n_loops=0, seed=1)
    tg = tbuild.switchable_pose_graph(data, s_init=np.zeros(0), **CPU)
    _same_graph(tg, jbuild.switchable_pose_graph(data, dtype=jnp.float64, s_init=np.zeros(0)))
    assert tg.blocks["switches"].values.shape == (1, 1) and tg.batches[1].n == 0
    solved, info = tlm.solve(tg, tlm.Options(method="lm", max_iters=10))
    assert torch.isfinite(info.chi2) and solved.blocks["switches"].values.item() == 1.0


def test_vertigo_file_to_graph(tmp_path):
    """``read_g2o_switchable``'s per-edge xi and s_init straight into the
    builder, as the reference's file-to-solve test does."""
    _, tp, _, _ = _poisoned(2)
    loop_mask = np.abs(np.asarray(tp.edges_i) - np.asarray(tp.edges_j)) != 1
    rng = np.random.default_rng(2)
    path = str(tmp_path / "vertigo.g2o")
    tg2o.write_g2o_switchable(path, tp, loop_mask, xi=rng.uniform(2, 8, int(loop_mask.sum())),
                              s_init=rng.uniform(0.5, 1, int(loop_mask.sum())))
    data, sw = tg2o.read_g2o_switchable(path)
    _same_graph(tbuild.switchable_pose_graph(data, **sw, **CPU),
                jbuild.switchable_pose_graph(data, dtype=jnp.float64, **sw))


def test_dense_assembly_of_three_slot_factors():
    """H and g of a switchable graph against the reference's dense
    assembly, with one loop factor whose two pose slots name the same pose
    and the switch column (m + 1) x 1 of every loop factor."""
    jp, tp, _, _ = _poisoned(3)
    jg = jbuild.switchable_pose_graph(jp, dtype=jnp.float64, xi=5.0)
    fb = jg.batches[1]
    ei = np.asarray(fb.indices[0]).copy()
    ei[0] = int(np.asarray(fb.indices[1])[0])  # pose_i == pose_j
    jg = dataclasses.replace(jg, batches=[jg.batches[0], dataclasses.replace(fb, indices=(jnp.asarray(ei),) + fb.indices[1:])])
    tg = to_port(jg)
    H_t, g_t, c_t = tassemble.assemble_dense(tg)
    H_j, g_j, c_j = jassemble.assemble_dense(jg)
    scale = np.abs(np.asarray(H_j)).max()
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0, atol=1e-10 * np.abs(np.asarray(g_j)).max())
    np.testing.assert_allclose(c_t.item(), float(c_j), rtol=1e-10)
    plan = tassemble.dense_plan(tg)
    assert (6, 1) in {grp.shape for grp in plan.h_groups} and (1, 1) in {grp.shape for grp in plan.h_groups}


@pytest.fixture(scope="module")
def reference_solves():
    out = {}
    for dim in (2, 3):
        jp, _, _, _ = _poisoned(dim)
        out[dim] = jlm.solve(jbuild.switchable_pose_graph(jp, dtype=jnp.float64, xi=5.0),
                             jlm.Options(method="lm", max_iters=60))
    return out


@pytest.mark.parametrize("dim", [2, 3])
def test_switchable_solve_matches_reference(dim, reference_solves):
    _, tp, n_real, n_bad = _poisoned(dim)
    solved, info = tlm.solve(tbuild.switchable_pose_graph(tp, xi=5.0, **CPU), tlm.Options(method="lm", max_iters=60))
    js, ji = reference_solves[dim]
    assert (info.iterations, info.status) == (int(ji.iterations), int(ji.status))
    np.testing.assert_array_equal(info.accepted.numpy(), np.asarray(ji.accepted))
    np.testing.assert_allclose(info.chi2.item(), float(ji.chi2), rtol=1e-8)
    s = solved.blocks["switches"].values.numpy()[:, 0]
    np.testing.assert_allclose(s, np.asarray(js.blocks["switches"].values)[:, 0], rtol=0, atol=1e-6)
    # the wrong loops switch themselves off, the real ones stay on
    assert s[-n_bad:].max() < 0.25 and s[:n_real].min() > 0.75
