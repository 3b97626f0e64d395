"""Marginalization of the torch port (``graph/marginalize.py``) against the
JAX reference, in f64 on the CPU, on the same graphs carried across with
``graph_from_numpy`` (the cases of ``tests/test_marginalize.py``).

Tolerances: the marginalized graph's blocks, indices, weights and prior
linearization points exactly; the prior's AᵀA and Aᵀc (A and c themselves
depend on ``eigh``'s eigenvector signs and the order of repeated
eigenvalues) 1e-9 relative to their largest entry, absolute 1e-9 where that
is below 1 (at an optimum Aᵀc is roundoff); chi2 1e-10 relative;
solves of the marginalized graphs 1e-9 on the poses against the reference's
solve, and the reference's own criteria (1e-4 to the full optimum, 1e-8 to
dead reckoning) against the ground truth of each case.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import to_port

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph import marginalize as jmarg
from pyslam_tpu.graph.core import FactorBatch as JFB
from pyslam_tpu.graph.core import FactorGraph as JFG
from pyslam_tpu.graph.core import VariableBlock as JVB
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu.solver import Options as JOptions
from pyslam_tpu.solver import solve as jsolve
from pyslam_tpu.solver.bcsr import solve_ell as jsolve_ell
from pyslam_tpu_torch.graph import FACTOR_KERNELS, FactorBatch, FactorGraph, VariableBlock, marginalize
from pyslam_tpu_torch.lie import se2, se3
from pyslam_tpu_torch.losses import L2Loss
from pyslam_tpu_torch.solver import Options, assemble_dense, solve, solve_ell
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.fixture(scope="module")
def optima():
    """The JAX optima of the reference's se2 / se3 / BA cases."""
    se2_g, _ = jsolve(jbuild.pose_graph(jsynth.se2_loop(n_poses=30, n_loops=6, seed=1), dtype=F64),
                      JOptions(method="lm", max_iters=50))
    se3_g, _ = jsolve(jbuild.pose_graph(jsynth.se3_sphere(n_poses=25, n_loops=8, seed=3), dtype=F64),
                      JOptions(method="lm", max_iters=50))
    ba_g, _ = jsolve(jbuild.ba_graph(jsynth.ba_synthetic(n_cams=6, n_pts=40, seed=0), dtype=F64),
                     JOptions(method="lm", max_iters=40))
    return {"se2": se2_g, "se3": se3_g, "ba": ba_g}


def assert_same_graph(tg, jg):
    """Structure, values and weights exactly; the dense priors by AᵀA and
    Aᵀc within 1e-9 relative (absolute below 1)."""
    assert list(tg.blocks) == list(jg.blocks)
    for name, jb in jg.blocks.items():
        tb = tg.blocks[name]
        assert tb.kind == jb.kind
        np.testing.assert_array_equal(_np(tb.values), np.asarray(jb.values))
        np.testing.assert_array_equal(_np(tb.const_mask), np.asarray(jb.const_mask))
    assert [(fb.kind, fb.slots) for fb in tg.batches] == [(fb.kind, fb.slots) for fb in jg.batches]
    for tf, jf in zip(tg.batches, jg.batches):
        for a, b in zip(tf.indices, jf.indices):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        np.testing.assert_array_equal(_np(tf.weight), np.asarray(jf.weight))
        if not tf.kind.startswith("dense_prior__"):
            continue
        for k in jf.data:
            if k.startswith("x0_"):
                np.testing.assert_array_equal(_np(tf.data[k]), np.asarray(jf.data[k]))
        A, c = _np(tf.data["A"])[0], _np(tf.data["c"])[0]
        jA, jc = np.asarray(jf.data["A"])[0], np.asarray(jf.data["c"])[0]
        for out, ref in ((A.T @ A, jA.T @ jA), (A.T @ c, jA.T @ jc)):
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9 * max(np.abs(ref).max(), 1.0))


def _log_err(ops, a, b):
    return ops.log(torch.tensor(np.asarray(a)) @ ops.inv(torch.tensor(np.asarray(b)))).abs().max().item()


@pytest.mark.parametrize("kind,targets", [("se2", [5, 6, 12]), ("se3", [7, 8])])
def test_kept_poses_stay_at_optimum(optima, kind, targets):
    jg = optima[kind]
    jg2 = jmarg(jg, {"poses": targets})
    tg2 = marginalize(to_port(jg), {"poses": targets})
    assert_same_graph(tg2, jg2)
    np.testing.assert_allclose(tg2.chi2().item(), float(jg2.chi2()), rtol=1e-10)
    t3, _ = solve(tg2, Options(method="lm", max_iters=30))
    n = jg.blocks["poses"].n
    keep = np.setdiff1d(np.arange(n), targets)
    ops = se2 if kind == "se2" else se3
    assert _log_err(ops, np.asarray(jg.blocks["poses"].values)[keep], t3.blocks["poses"].values) < 1e-4
    if kind == "se2":
        j3, _ = jsolve(jg2, JOptions(method="lm", max_iters=30))
        np.testing.assert_allclose(_np(t3.blocks["poses"].values), np.asarray(j3.blocks["poses"].values), rtol=0,
                                   atol=1e-9)


def test_chi2_preserved_at_linearization(optima):
    jg = optima["se2"]
    tg2 = marginalize(to_port(jg), {"poses": [5, 6, 12]})
    np.testing.assert_allclose(tg2.chi2().item(), float(jg.chi2()), rtol=1e-6)


def test_odometry_chain_composition():
    data = jsynth.se2_loop(n_poses=10, n_loops=0, seed=2)
    jg = jbuild.pose_graph(data, dtype=F64)
    targets = {"poses": list(range(1, 9))}
    tg2 = marginalize(to_port(jg), targets)
    assert_same_graph(tg2, jmarg(jg, targets))
    assert tg2.blocks["poses"].n == 2
    t3, _ = solve(tg2, Options(method="lm", max_iters=20))
    np.testing.assert_allclose(_np(t3.blocks["poses"].values[1]), data.T_init[9], rtol=0, atol=1e-8)


def test_cull_landmarks(optima):
    jg = optima["ba"]
    targets = {"landmarks": [3, 11, 25]}
    tg2 = marginalize(to_port(jg), targets)
    assert_same_graph(tg2, jmarg(jg, targets))
    assert tg2.blocks["landmarks"].n == 37
    prior = [fb for fb in tg2.batches if fb.kind.startswith("dense_prior")]
    assert len(prior) == 1 and all(s == "poses" for s in prior[0].slots)
    t3, _ = solve(tg2, Options(method="lm", max_iters=30))
    assert _log_err(se3, jg.blocks["poses"].values, t3.blocks["poses"].values) < 1e-4


def _rank1_graph():
    """Two SE(2) poses joined by one factor that measures 1 of 3 dof."""
    sqrt_info = np.zeros((1, 3, 3))
    sqrt_info[0, 0, 0] = 1.0
    blocks = {"poses": VariableBlock.create("se2", torch.eye(3, dtype=torch.float64).expand(2, 3, 3).clone())}
    batch = FactorBatch.create("between_se2", slots=("poses", "poses"), indices=(np.array([0]), np.array([1])),
                               data={"T_obs": torch.eye(3, dtype=torch.float64)[None],
                                     "sqrt_info": torch.from_numpy(sqrt_info)}, loss=L2Loss())
    return FactorGraph(blocks, [batch])


@pytest.mark.parametrize("case", ["constant", "unknown_block", "underconstrained", "underconstrained_empty_blanket"])
def test_validation_raises(optima, case):
    tg = to_port(optima["se2"])
    if case == "constant":
        with pytest.raises(ValueError, match="constant"):
            marginalize(tg, {"poses": [0]})  # the gauge anchor
    elif case == "unknown_block":
        with pytest.raises(ValueError, match="unknown block"):
            marginalize(tg, {"nope": [0]})
    else:
        targets = [0] if case == "underconstrained" else [0, 1]
        with pytest.raises(ValueError, match="constrained"):
            marginalize(_rank1_graph(), {"poses": targets})


def test_isolated_variable_just_dropped():
    jg = jbuild.pose_graph(jsynth.se2_loop(n_poses=5, n_loops=0, seed=4), dtype=F64)
    tg2 = marginalize(to_port(jg), {"poses": [4]})
    jg2 = jmarg(jg, {"poses": [4]})
    assert_same_graph(tg2, jg2)
    tg3 = marginalize(tg2, {"poses": [3]})
    assert_same_graph(tg3, jmarg(jg2, {"poses": [3]}))
    assert tg3.blocks["poses"].n == 3


def test_sequential_equals_joint(optima):
    tg = to_port(optima["se2"])
    g_seq = marginalize(marginalize(tg, {"poses": [5]}), {"poses": [5]})
    g_joint = marginalize(tg, {"poses": [5, 6]})
    s1, _ = solve(g_seq, Options(method="lm", max_iters=30))
    s2, _ = solve(g_joint, Options(method="lm", max_iters=30))
    assert _log_err(se2, s1.blocks["poses"].values, s2.blocks["poses"].values) < 1e-5


def _chain_with_chord():
    """a-b-c-d-e SE(3) chain with a prior on a and an extra a-c edge, at
    random measurements (``tests/test_marginalize.py``'s no-double-count
    case as a plain graph)."""
    from pyslam_tpu.lie import se3 as jse3

    rng = np.random.default_rng(11)
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 2)]
    meas = [np.asarray(jse3.exp(jnp.asarray(rng.normal(size=6) * 0.2))) for _ in edges]
    si = [np.eye(6) * (2.0 if (i, j) == (0, 2) else 5.0) for i, j in edges]
    blocks = {"poses": JVB.create("se3", jnp.asarray(np.tile(np.eye(4), (5, 1, 1))))}
    between = JFB.create("between_se3", slots=("poses", "poses"),
                         indices=(np.array([i for i, _ in edges], np.int32), np.array([j for _, j in edges], np.int32)),
                         data={"T_obs": jnp.asarray(np.stack(meas)), "sqrt_info": jnp.asarray(np.stack(si))},
                         loss=JL2())
    prior = JFB.create("prior_se3", slots=("poses",), indices=(np.array([0], np.int32),),
                       data={"T_obs": jnp.eye(4, dtype=F64)[None], "sqrt_info": 10.0 * jnp.eye(6, dtype=F64)[None]},
                       loss=JL2())
    return JFG(blocks, [between, prior])


def _pose_covariance(g, i):
    H, _, _ = assemble_dense(g)
    return np.linalg.inv(_np(H))[6 * i : 6 * i + 6, 6 * i : 6 * i + 6]


def test_repeated_disjoint_marginalization_no_double_count():
    """b, then e (disjoint): the (a, c) prior appears once, and the kept
    pose c keeps its covariance up to the FEJ effect; the reference's
    graph after the same two steps has the same priors."""
    jg, _ = jsolve(_chain_with_chord(), JOptions(method="lm", max_iters=40))
    tg = to_port(jg)
    cov_c0 = _pose_covariance(tg, 2)
    t1 = marginalize(tg, {"poses": [1]})
    t2 = marginalize(t1, {"poses": [3]})  # e, after b's removal
    j2 = jmarg(jmarg(jg, {"poses": [1]}), {"poses": [3]})
    assert_same_graph(t2, j2)
    assert [fb.kind.startswith("dense_prior") for fb in t1.batches].count(True) == 1
    assert [fb.kind.startswith("dense_prior") for fb in t2.batches].count(True) == 2
    s2, _ = solve(t2, Options(method="lm", max_iters=40))
    np.testing.assert_allclose(_pose_covariance(s2, 1), cov_c0, rtol=5e-3)


def test_shared_unbatched_data_survives():
    data = jsynth.ba_synthetic(n_cams=2, n_pts=3, seed=1)
    g = jbuild.ba_graph(data, dtype=F64)
    fb = g.batches[0]
    sel = np.arange(3)
    g = JFG(g.blocks, [JFB(fb.kind, fb.slots, tuple(jnp.asarray(np.asarray(ix)[sel]) for ix in fb.indices),
                           {k: (jnp.asarray(np.asarray(v)[sel]) if k == "obs" else v) for k, v in fb.data.items()},
                           fb.loss, jnp.asarray(np.asarray(fb.weight)[sel]))])
    lm_id = int(np.asarray(g.batches[0].indices[1])[0])
    tg2 = marginalize(to_port(g), {"landmarks": [lm_id]})
    assert_same_graph(tg2, jmarg(g, {"landmarks": [lm_id]}))
    kept = [b for b in tg2.batches if b.kind == fb.kind]
    assert kept and tuple(kept[0].data["sqrt_info"].shape) == (3, 3)
    np.testing.assert_array_equal(_np(kept[0].data["sqrt_info"]), np.asarray(fb.data["sqrt_info"]))


def test_reference_marginalized_graph_carries_across(optima):
    """A graph marginalized by the JAX package, through ``graph_from_numpy``
    (which registers its ``dense_prior__`` kind): the same chi2 and the
    same solve."""
    jg2 = jmarg(optima["se2"], {"poses": [3, 4, 20]})
    kind = next(fb.kind for fb in jg2.batches if fb.kind.startswith("dense_prior"))
    FACTOR_KERNELS.pop(kind, None)
    tg2 = to_port(jg2)
    assert kind in FACTOR_KERNELS
    np.testing.assert_allclose(tg2.chi2().item(), float(jg2.chi2()), rtol=1e-10)
    t3, _ = solve(tg2, Options(method="lm", max_iters=30))
    j3, _ = jsolve(jg2, JOptions(method="lm", max_iters=30))
    np.testing.assert_allclose(_np(t3.blocks["poses"].values), np.asarray(j3.blocks["poses"].values), rtol=0,
                               atol=1e-9)


def test_marginalized_pose_graph_through_solve_ell(optima):
    """A many-slot prior over one SE(3) pose block goes through the ELL path
    (``build_ell_direct``), as the reference's does."""
    jg = optima["se3"]
    jg = dataclasses.replace(jg, blocks={"poses": JVB("se3", jg.blocks["poses"].values, jg.blocks["poses"].const_mask)})
    jg2 = jmarg(jg, {"poses": [7, 8, 15]})
    prior = [fb for fb in jg2.batches if fb.kind.startswith("dense_prior")]
    assert len(prior) == 1 and len(prior[0].slots) >= 3
    tg2 = to_port(jg2)
    rng = np.random.default_rng(0)
    noise = 0.05 * rng.standard_normal((tg2.blocks["poses"].n, 6))
    noise[0] = 0.0
    start = tg2.retract_all(torch.from_numpy(noise.reshape(-1)))
    jstart = dataclasses.replace(jg2, blocks={"poses": JVB("se3", jnp.asarray(_np(start.blocks["poses"].values)),
                                                           jg2.blocks["poses"].const_mask)})
    opts = dict(method="lm", max_iters=20)
    t3, ti = solve_ell(start, Options(**opts), pcg_rtol=1e-10, pcg_max_iters=200)
    j3, ji = jsolve_ell(jstart, JOptions(**opts), pcg_rtol=1e-10, pcg_max_iters=200)
    assert ti.iterations == int(ji.iterations)
    np.testing.assert_allclose(ti.chi2.item(), float(ji.chi2), rtol=1e-9)
    np.testing.assert_allclose(_np(t3.blocks["poses"].values), np.asarray(j3.blocks["poses"].values), rtol=0,
                               atol=1e-8)


def test_vio_window_marginalization_matches_reference():
    """The step of ``examples/vio_sliding_window.py``: a (pose, velocity,
    bias) triple folded out of a VIO graph (5-slot IMU factors, bias walks,
    pose priors); then the port's sliding-window driver
    (``testing.vio_sliding_window``, window 3 over 7 keyframes, so four
    such marginalizations) keeps the newest pose within the example's 1e-2
    of the truth."""
    from pyslam_tpu import imu as jimu
    from pyslam_tpu_torch.io import synth as tsynth
    from pyslam_tpu_torch.testing import vio_sliding_window

    d = jsynth.imu_circle(n_keyframes=6, kf_dt=0.5, imu_rate=50, seed=0)
    jg = jimu.vio_graph(d, d.T_gt, np.diag([1 / 2e-3] * 6))
    triple = {"poses": [0], "vels": [0], "biases": [0]}
    j1 = jmarg(jg, triple)
    t1 = marginalize(to_port(jg), triple)
    assert_same_graph(t1, j1)
    np.testing.assert_allclose(t1.chi2().item(), float(j1.chi2()), rtol=1e-10, atol=1e-12)

    d = tsynth.imu_circle(n_keyframes=7, kf_dt=0.5, imu_rate=100, gyro_noise=1.7e-4 * np.sqrt(100),
                          accel_noise=2e-3 * np.sqrt(100), b_gyro=np.array([0.002, -0.001, 0.003]), seed=0)
    rng = np.random.default_rng(1)
    T_meas = np.stack([_np(se3.exp(torch.from_numpy(rng.normal(size=6) * 2e-3))) @ d.T_gt[i] for i in range(7)])
    errs, chi2, iters, g = vio_sliding_window(d, T_meas, window=3, device="cpu")
    assert len(errs) == 6 and max(errs) < 1e-2 and g.blocks["poses"].n == 3
    assert [fb.kind.startswith("dense_prior") for fb in g.batches].count(True) == 1
