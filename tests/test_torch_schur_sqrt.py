"""Square-root bundle adjustment of the torch port (``solver/schur_sqrt.py``)
against the JAX reference on the same graphs, carried across with
``graph_from_numpy``: the cases of ``tests/test_schur_sqrt.py``.

Tolerances: in f64 every solve takes the reference's LM iterations and
stop code, chi2 within 1e-10 relative and the solved values within 1e-9
(both run the same reflections; the sums into the reduced system run in
other orders); the plan's buckets are the reference's exactly.  In f32 on
the low-parallax monocular graph, the reference's own bound: chi2 within
1e-4 of the f64 solve (measured 6.2e-5; the reference's f32 solve 2.1e-6:
the conditioning amplifies the rounding of either), and the plan of the
reduced system's camera-pair sums (every row to its pair's slot).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import to_port

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorBatch as JFB
from pyslam_tpu.graph.core import FactorGraph as JFG
from pyslam_tpu.io import bal as jbal
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.losses import HuberLoss as JHuber
from pyslam_tpu.solver import Options as JOptions
from pyslam_tpu.solver import schur_sqrt as jsq
from pyslam_tpu_torch.solver import Options, schur_sqrt, solve_schur
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64


def stereo_graph(loss=None, seed=8):
    data = jsynth.ba_synthetic(n_cams=6, n_pts=40, obs_per_pt=4, seed=seed)
    return jbuild.ba_graph(data, loss=loss, dtype=F64)


def with_pose_prior(g):
    pb = g.blocks["poses"]
    prior = JFB.create(kind="prior_se3", slots=("poses",), indices=(np.array([1, 4, 1], np.int32),),
                       data={"T_obs": jnp.asarray(np.asarray(pb.values)[[1, 4, 1]]),
                             "sqrt_info": 1e2 * jnp.tile(jnp.eye(6, dtype=F64)[None], (3, 1, 1))},
                       loss=g.batches[0].loss)
    return JFG(dict(g.blocks), [g.batches[0], prior])


def bal_graph(dtype=F64, **kw):
    return jbuild.bal_graph(jbal.perturbed(jbal.synthetic_bal(n_cams=6, n_pts=50, seed=0, **kw), seed=1), dtype=dtype)


CASES = {
    "stereo": (stereo_graph, dict(method="lm", max_iters=25)),
    "stereo_gn": (stereo_graph, dict(method="gn", max_iters=8)),
    "bal": (bal_graph, dict(method="lm", max_iters=25)),
    "huber": (lambda: stereo_graph(loss=JHuber(2.0)), dict(method="lm", max_iters=20)),
    "pose_prior": (lambda: with_pose_prior(stereo_graph()), dict(method="lm", max_iters=25)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_matches_reference(name):
    make, opts = CASES[name]
    jg = make()
    tg = to_port(jg)
    ts, ti = schur_sqrt.solve_schur_sqrt(tg, Options(**opts))
    js, ji = jsq.solve_schur_sqrt(jg, JOptions(**opts))
    assert (ti.iterations, ti.status) == (int(ji.iterations), int(ji.status))
    np.testing.assert_allclose(ti.chi2.item(), float(ji.chi2), rtol=1e-10)
    for n, b in js.blocks.items():
        np.testing.assert_allclose(ts.blocks[n].values.numpy(), np.asarray(b.values), rtol=0, atol=1e-9)
    if name in ("stereo", "pose_prior"):
        # the same chi2 as the normal-equation Schur path (the reference's check)
        _, di = solve_schur(tg, Options(**opts), mode="dense")
        np.testing.assert_allclose(ti.chi2.item(), di.chi2.item(), rtol=1e-6)
    if name == "huber":
        assert ti.chi2.item() < 0.2 * tg.chi2().item()


def test_gauge_anchor_fixed():
    tg = to_port(stereo_graph())
    solved, _ = schur_sqrt.solve_schur_sqrt(tg, Options(method="lm", max_iters=10))
    np.testing.assert_array_equal(solved.blocks["poses"].values[0].numpy(), tg.blocks["poses"].values[0].numpy())


def test_bucketing_covers_all_observed():
    jg = stereo_graph(seed=3)
    tplan = schur_sqrt.build_sqrt_plan(to_port(jg))
    jplan = jsq.build_sqrt_plan(jg)
    assert (tplan.C, tplan.L, tplan.dp, tplan.dl, tplan.m, tplan.pose_first) == (
        jplan.C, jplan.L, jplan.dp, jplan.dl, jplan.m, jplan.pose_first)
    assert len(tplan.buckets) == len(jplan.buckets)
    for tb, jb in zip(tplan.buckets, jplan.buckets):
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, np.asarray(b))
    covered = np.sort(np.concatenate([lms for lms, _, _ in tplan.buckets]))
    pt = np.asarray(jg.batches[0].indices[1])
    np.testing.assert_array_equal(covered, np.unique(pt))
    assert sum(int(mask.sum()) for _, _, mask in tplan.buckets) == jg.batches[0].n
    # every bucket's (l, a, b) camera pair and (l, a) camera has a plan row
    rows = sum(mask.size * mask.shape[1] for _, _, mask in tplan.buckets)
    assert len(tplan.pair_plan[0]) == rows and len(tplan.grad_plan[0]) == sum(m.size for _, _, m in tplan.buckets)


def test_unsupported_graphs_raise():
    jg = stereo_graph()
    tg = to_port(jg)
    between = JFB.create(kind="between_se3", slots=("poses", "poses"),
                         indices=(np.array([0], np.int32), np.array([1], np.int32)),
                         data={"T_obs": jnp.eye(4, dtype=F64)[None], "sqrt_info": jnp.eye(6, dtype=F64)[None]},
                         loss=jg.batches[0].loss)
    with pytest.raises(ValueError, match="unsupported slots"):
        schur_sqrt.build_sqrt_plan(to_port(JFG(dict(jg.blocks), [jg.batches[0], between])))
    with pytest.raises(ValueError, match="exactly one"):
        schur_sqrt.build_sqrt_plan(to_port(JFG(dict(jg.blocks), [jg.batches[0], jg.batches[0]])))
    assert schur_sqrt.build_sqrt_plan(tg).dl == 3


def test_f32_low_parallax_monocular():
    """Clustered monocular cameras (``cam_cluster=0.05``): the f32 square-root
    solve within 1e-4 of the f64 normal-equation solve, as the reference
    holds its own; the plan of its reduced-system sums."""
    opts = dict(method="lm", max_iters=50)
    g64 = to_port(bal_graph(cam_cluster=0.05))
    _, ref = solve_schur(g64, Options(**opts), mode="dense")
    g32 = to_port(bal_graph(jnp.float32, cam_cluster=0.05), dtype=torch.float32)
    _, b = schur_sqrt.solve_schur_sqrt(g32, Options(**opts))
    assert abs(b.chi2.item() - ref.chi2.item()) / ref.chi2.item() < 1e-4
    plan = schur_sqrt.build_sqrt_plan(g32)
    # the camera-pair plan: its slots are the co-observing pairs, each
    # receiving exactly the (l, a, b) rows of its two cameras
    perm, offsets = plan.pair_plan
    cams = np.concatenate([np.asarray(g32.batches[0].indices[0])[obs_idx] for _, obs_idx, _ in plan.buckets])
    flat = (cams[:, :, None] * plan.C + cams[:, None, :]).reshape(-1)
    assert np.array_equal(np.unique(flat), plan.pair_blocks)
    slot_of_row = np.repeat(np.arange(len(plan.pair_blocks)), np.diff(offsets))
    np.testing.assert_array_equal(plan.pair_blocks[slot_of_row], flat[perm])
