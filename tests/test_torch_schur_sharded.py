"""Landmark-sharded Schur bundle adjustment of the torch port
(``dist/schur_reduce.py``, bench config 5's path) on gloo ranks spawned on
the CPU, against the JAX reference's ``solve_schur_sharded`` on a mesh of
as many of the conftest's CPU devices, with the same landmark partition,
in f64, on the same numpy inputs: plain and robust stereo BA, a pose
prior, (pose, pose) between factors, an SE(2) landmark graph and 9-dof
``bal_cam9`` cameras.

The ranks (1, 3, then 2 for the kill-one-host drill) are started once for
the module; each group runs its jobs and the tests read their results.
Tolerances: the same LM iterations, stop code and accept sequence (the
lambda of every LM iteration), the accepted costs and the final chi2
within 1e-9 relative, the values within 1e-8.  The same against the
port's single-device ``solve_schur`` (PCG 1e-10); 1e-9 between mesh sizes
and partitions; the same bits on every rank and for two solves.

The sharded marginals (``sharded_pose_marginals``,
``sharded_landmark_marginals``) run on a group of two ranks of their own:
the same bits on both, within 1e-7 of the reference's on two CPU devices
and of the port's single-device marginals (PCG 1e-10 on every side).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_ranks import run_group, to_arrays

import pyslam_tpu.solver.host_loop as j_host_loop
from pyslam_tpu.dist import make_mesh as j_make_mesh
from pyslam_tpu.dist import solve_schur_sharded as j_solve
from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorBatch as JFactorBatch
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.io import bal as jbal
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.losses import HuberLoss as JHuber
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu.solver import Options as JOptions
from pyslam_tpu_torch import dist
from pyslam_tpu_torch.graph import graph_from_numpy
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver import schur
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64


def _stereo(seed=3, loss=None, n_cams=8, n_pts=64, obs_per_pt=4):
    return jbuild.ba_graph(jsynth.ba_synthetic(n_cams=n_cams, n_pts=n_pts, obs_per_pt=obs_per_pt, seed=seed),
                           loss=loss, dtype=F64)


def _prior():
    """Camera 0's prior added to a graph (the reference's
    ``test_with_pose_prior_unary``)."""
    g = _stereo(seed=11, n_cams=6, n_pts=40)
    T0 = np.asarray(g.blocks["poses"].values[:1])
    prior = JFactorBatch.create(kind="prior_se3", slots=("poses",), indices=(np.array([0], np.int32),),
                                data={"T_obs": jnp.asarray(T0, F64), "sqrt_info": 1e3 * jnp.eye(6, dtype=F64)[None]},
                                loss=g.batches[0].loss)
    return JFactorGraph(dict(g.blocks), [g.batches[0], prior])


def _between():
    """Observations and an odometry chain (``TestShardedFullSlam``)."""
    data = jsynth.ba_synthetic(n_cams=8, n_pts=50, obs_per_pt=4, seed=12)
    g = jbuild.ba_graph(data, dtype=F64)
    Ti = np.arange(7, dtype=np.int32)
    T_obs = np.stack([data.T_gt[j] @ np.linalg.inv(data.T_gt[i]) for i, j in zip(Ti, Ti + 1)])
    between = JFactorBatch.create(kind="between_se3", slots=("poses", "poses"), indices=(Ti, Ti + 1),
                                  data={"T_obs": jnp.asarray(T_obs, F64),
                                        "sqrt_info": jnp.broadcast_to(10.0 * jnp.eye(6, dtype=F64), (7, 6, 6))},
                                  loss=JL2())
    return JFactorGraph(dict(g.blocks), [g.batches[0], between])


GRAPHS = {
    "stereo": lambda: _stereo(),
    "huber": lambda: _stereo(loss=JHuber(2.0)),
    "prior": _prior,
    "between": _between,
    "se2": lambda: jbuild.landmark_slam_2d(
        jsynth.landmark_slam_2d(n_poses=30, n_landmarks=20, max_range=9.0, seed=1), dtype=F64),
    "bal9": lambda: jbuild.bal_graph(jbal.perturbed(jbal.synthetic_bal(n_cams=8, n_pts=60, seed=0)),
                                     optimize_intrinsics=True, dtype=F64),
}
OPTIONS = dict(method="lm", max_iters=15)
# CG budgets above what these graphs need at these tolerances
# (schur_large.cg_iterations() reads it): the port's loop runs to its
# budget, its iterate frozen
PCG = dict(pcg_rtol=1e-10, pcg_max_iters=80)
# the checkpoint drills (the reference's): 8 iterations at once, or 4, a
# checkpoint, and 4 more from it
CK = dict(pcg_rtol=1e-12, pcg_max_iters=60)
CK_FULL = dict(method="lm", max_iters=8, min_cost_decrease=1.0 - 1e-15)
CK_HALF = dict(method="lm", max_iters=4, min_cost_decrease=1.0 - 1e-15)
CK_GRAPH = "stereo"
AUTO_OPTIONS = dict(method="lm", max_iters=3)


def _graph(name):
    jg = GRAPHS[name]()
    return jg, to_arrays(jg)


ARRAYS = {name: _graph(name) for name in GRAPHS}
L_STEREO = ARRAYS["stereo"][0].blocks["landmarks"].n
RANDOM_PART = np.random.default_rng(0).integers(0, 3, L_STEREO)
EMPTY_RANK_PART = 1 + np.arange(L_STEREO) % 2  # rank 0 owns no landmark


# the sharded marginals: graphs (with the pose-pose coupling of 'between'),
# the queries, and a PCG tolerance far below the 1e-7 they are held to
MARGINAL_GRAPHS = ["between", "se2"]
MARGINAL_POSES = [0, 2, 5]
MARGINAL_LANDMARKS = [0, 7, 19]
MARGINAL_PCG = dict(pcg_rtol=1e-10, pcg_max_iters=200)


def marginals_job(name):
    return dict(key=f"marginals_{name}", solver="marginals", graph=ARRAYS[name][1],
                kw=dict(poses=MARGINAL_POSES, landmarks=MARGINAL_LANDMARKS, **MARGINAL_PCG))


def job(key, name, options=OPTIONS, **kw):
    return dict(key=key, solver="schur", graph=ARRAYS[name][1], options=options, kw={**PCG, **kw})


def jax_solve(name, n, monkeypatch=None, options=OPTIONS, **kw):
    record = {"lams": []}
    if monkeypatch is not None:
        loop = j_host_loop.host_lm_loop

        def recorded(step, state, opts, on_accept=None):
            def rec(state, lam):
                record["lams"].append(lam)
                return step(state, lam)

            out = loop(rec, state, opts, on_accept)
            record["info"] = out[2]
            return out

        monkeypatch.setattr(j_host_loop, "host_lm_loop", recorded)
    solved, chi2, history = j_solve(ARRAYS[name][0], j_make_mesh(n, axis_name="l"), JOptions(**options),
                                    **{**PCG, **kw})
    if monkeypatch is not None:
        monkeypatch.undo()
    values = {k: np.asarray(b.values) for k, b in solved.blocks.items()}
    return dict(chi2=chi2, history=history, values=values, **record)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: [each rank's results]}; the checkpoint files under
    ``tmp``.  The JAX package writes its checkpoint first."""
    tmp = tmp_path_factory.mktemp("schur_sharded")
    ck3, bare, jax_ck = str(tmp / "ck3.npz"), str(tmp / "bare.ck"), str(tmp / "jax.npz")
    jax_solve(CK_GRAPH, 3, options=CK_HALF, checkpoint_path=jax_ck, checkpoint_every=4, **CK)
    ck_jobs = [
        job("ck_full", CK_GRAPH, CK_FULL, **CK),
        job("ck_write", CK_GRAPH, CK_HALF, checkpoint_path=ck3, checkpoint_every=4, **CK),
        job("ck_resume", CK_GRAPH, CK_HALF, checkpoint_path=ck3, resume=True, **CK),
        job("bare_write", CK_GRAPH, CK_HALF, checkpoint_path=bare, checkpoint_every=4, **CK),
        job("bare_resume", CK_GRAPH, CK_HALF, checkpoint_path=bare, resume=True, **CK),
        job("jax_resume", CK_GRAPH, CK_HALF, checkpoint_path=jax_ck, resume=True, **CK),
    ]
    three = [job(name, name) for name in GRAPHS] + [
        job("stereo_again", "stereo"),
        job("random_part", "stereo", partition=RANDOM_PART),
        job("empty_rank", "stereo", partition=EMPTY_RANK_PART),
        # solve_auto runs the solver's default PCG budget
        dict(key="stereo_default_pcg", solver="schur", graph=ARRAYS["stereo"][1], options=AUTO_OPTIONS),
        dict(key="auto", solver="auto", graph=ARRAYS["stereo"][1], options=AUTO_OPTIONS,
             kw=dict(route="schur_reduce")),
    ] + ck_jobs
    # the three groups together take about 41 s
    out = {3: run_group(3, three, tmp, timeout_s=125)}
    # one host died: the checkpoint of three ranks resumes on two
    out[2] = run_group(2, [job("ck_resume", CK_GRAPH, CK_HALF, checkpoint_path=ck3, resume=True, **CK)], tmp,
                       timeout_s=125)
    out[1] = run_group(1, [job("stereo", "stereo"), job("stereo_again", "stereo")], tmp, timeout_s=125)
    return out, dict(ck3=ck3, bare=bare, jax_ck=jax_ck)


def assert_same_solve(ours, ref, rel=1e-9, state=1e-8):
    assert (ours["info"]["iterations"], ours["info"]["status"]) == (ref["info"]["iterations"], ref["info"]["status"])
    np.testing.assert_allclose(ours["lams"], ref["lams"], rtol=1e-12)  # the accept sequence
    assert len(ours["history"]) == len(ref["history"])
    np.testing.assert_allclose(ours["history"], ref["history"], rtol=rel)
    np.testing.assert_allclose(ours["chi2"], ref["chi2"], rtol=rel)
    for k, v in ref["values"].items():
        np.testing.assert_allclose(ours["values"][k], v, rtol=0, atol=state)


def assert_bits(a, b):
    assert a["history"] == b["history"] and a["lams"] == b["lams"] and a["chi2"] == b["chi2"]
    for k in a["values"]:
        np.testing.assert_array_equal(a["values"][k], b["values"][k])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_matches_reference_on_three_ranks(ranks, monkeypatch, name):
    ours = ranks[0][3][0][name]
    assert_same_solve(ours, jax_solve(name, 3, monkeypatch))
    assert ours["history"][-1] < ours["history"][0]


def test_matches_reference_on_one_rank(ranks, monkeypatch):
    assert_same_solve(ranks[0][1][0]["stereo"], jax_solve("stereo", 1, monkeypatch))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_matches_the_single_device_solve(ranks, name):
    tg = graph_from_numpy(*ARRAYS[name][1], dtype=torch.float64, device="cpu")
    pose_name, lm_name = ("poses", "landmarks")
    solved, info = schur.solve_schur(tg, tlm.Options(**OPTIONS), mode="pcg", pose_name=pose_name, lm_name=lm_name,
                                     **PCG)
    ours = ranks[0][3][0][name]
    assert len(ours["history"]) - 1 == int(info.accepted[: info.iterations].sum())
    np.testing.assert_allclose(ours["chi2"], info.chi2.item(), rtol=1e-9)
    for k in ("poses", "landmarks"):
        np.testing.assert_allclose(ours["values"][k], solved.blocks[k].values.numpy(), rtol=0, atol=1e-8)


def test_every_rank_returns_the_same_solve(ranks):
    for n, group in ranks[0].items():
        for key in group[0]:
            for other in group[1:]:
                assert_bits(other[key], group[0][key])


@pytest.mark.parametrize("n", [1, 3])
def test_two_solves_give_the_same_bits(ranks, n):
    assert_bits(ranks[0][n][0]["stereo_again"], ranks[0][n][0]["stereo"])


def test_mesh_size_invariance(ranks):
    one, three = ranks[0][1][0]["stereo"], ranks[0][3][0]["stereo"]
    assert one["lams"] == three["lams"]
    np.testing.assert_allclose(three["history"], one["history"], rtol=1e-9)
    for k in one["values"]:
        np.testing.assert_allclose(three["values"][k], one["values"][k], rtol=0, atol=1e-9)


@pytest.mark.parametrize("key", ["random_part", "empty_rank"])
def test_partition_invariance(ranks, key):
    """A random partition, and one where rank 0 owns no landmark (no NaN:
    the rank sums nothing and still takes part in every collective)."""
    ref, ours = ranks[0][3][0]["stereo"], ranks[0][3][0][key]
    assert np.isfinite(ours["chi2"]) and ours["lams"] == ref["lams"]
    np.testing.assert_allclose(ours["history"], ref["history"], rtol=1e-9)
    for k in ref["values"]:
        np.testing.assert_allclose(ours["values"][k], ref["values"][k], rtol=0, atol=1e-9)


def test_gauge_anchor_stays_fixed(ranks):
    T0 = ARRAYS["stereo"][1][0]["poses"]["values"][0]
    np.testing.assert_allclose(ranks[0][3][0]["stereo"]["values"]["poses"][0], T0, rtol=0, atol=1e-12)


def test_collectives_per_iteration(ranks):
    """Per LM iteration: one sum for the cost and the camera blocks, one
    for g_red, one for D, one a CG iteration (the loop runs to its budget,
    its iterate frozen), one for the update norm and the trial cost; one
    gather of the landmarks for the result."""
    out = ranks[0][3][0]["stereo"]
    it = out["info"]["iterations"]
    assert out["collectives"] == {"psum": it * (4 + PCG["pcg_max_iters"]), "all_gather": 1}


def test_solve_auto_takes_the_schur_reduce_route(ranks):
    assert_bits(ranks[0][3][0]["auto"], ranks[0][3][0]["stereo_default_pcg"])


def test_checkpoint_resume_is_exact(ranks):
    out = ranks[0][3][0]
    assert os.path.exists(ranks[1]["ck3"])
    np.testing.assert_allclose(out["ck_resume"]["chi2"], out["ck_full"]["chi2"], rtol=1e-9)
    # the resumed solve starts where the first half ended
    np.testing.assert_allclose(out["ck_resume"]["history"][0], out["ck_write"]["history"][-1], rtol=1e-12)


def test_kill_one_host_drill(ranks):
    """Written by three ranks, resumed on two (new landmark shares)."""
    full, resumed = ranks[0][3][0]["ck_full"], ranks[0][2][0]["ck_resume"]
    assert resumed["history"][-1] <= resumed["history"][0]
    np.testing.assert_allclose(resumed["chi2"], full["chi2"], rtol=1e-9)


def test_checkpoint_path_without_npz_suffix(ranks):
    out, paths = ranks[0][3][0], ranks[1]
    assert os.path.exists(paths["bare"] + ".npz") and not os.path.exists(paths["bare"])
    np.testing.assert_allclose(out["bare_resume"]["chi2"], out["ck_full"]["chi2"], rtol=1e-9)


def test_checkpoint_keys_are_the_reference_s(ranks):
    ours, ref = np.load(ranks[1]["ck3"]), np.load(ranks[1]["jax_ck"])
    assert list(ours.keys()) == list(ref.keys()) == ["poses", "landmarks", "lam"]
    for k in ref.keys():
        assert ours[k].shape == ref[k].shape and ours[k].dtype == ref[k].dtype
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-9, atol=1e-10)


def test_a_checkpoint_of_the_jax_package_resumes_here(ranks):
    """The JAX package's checkpoint resumed by the port on three ranks ends
    at the chi2 of the JAX package's own resumed run.  (Past the checkpoint
    the steps are of the order of rounding, and whether one is accepted is
    rounding too: the drills compare the final chi2, as the reference's
    do.)"""
    ref = jax_solve(CK_GRAPH, 3, options=CK_HALF, checkpoint_path=ranks[1]["jax_ck"], resume=True, **CK)
    ours = ranks[0][3][0]["jax_resume"]
    np.testing.assert_allclose(ours["chi2"], ref["chi2"], rtol=1e-9)
    np.testing.assert_allclose(ours["history"][0], ref["history"][0], rtol=1e-12)  # the same start


def test_shard_ba_takes_either_observation_order():
    """A (landmark, pose) observation batch gives the same plan as the
    (pose, landmark) one."""
    from pyslam_tpu_torch.graph import FactorGraph
    from pyslam_tpu_torch.graph.core import FACTOR_KERNELS

    tg = graph_from_numpy(*ARRAYS["stereo"][1], dtype=torch.float64, device="cpu")
    kind = "reprojection_landmark_first"
    if kind not in FACTOR_KERNELS:  # registered by test_torch_schur_large when it runs first
        def _landmark_first(data, lm, pose, compute_jacobians=True):
            r, jacs = FACTOR_KERNELS["reprojection"](data, pose, lm, compute_jacobians=compute_jacobians)
            return r, (jacs[::-1] if compute_jacobians else None)

        FACTOR_KERNELS[kind] = _landmark_first
    fb = tg.batches[0]
    flipped = FactorGraph(tg.blocks, [dataclasses.replace(fb, kind=kind, slots=fb.slots[::-1],
                                                          indices=fb.indices[::-1])])
    mesh = dist.Mesh(group=None, rank=1, size=3, device=torch.device("cpu"), backend="gloo", axis_name="l")
    a, b = dist.shard_ba(tg, mesh), dist.shard_ba(flipped, mesh)
    assert a.pose_first and not b.pose_first
    for f in ("cam_idx", "pt_idx", "weight", "lms", "free_l"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert a.lm_counts == b.lm_counts == (21, 21, 22)
    from pyslam_tpu_torch.dist.schur_reduce import _observations

    ra, ja = _observations(a, a.poses, a.lms, True)
    rb, jb = _observations(b, b.poses, b.lms, True)
    assert torch.equal(ra, rb) and all(torch.equal(x, y) for x, y in zip(ja, jb))


@pytest.fixture(scope="module")
def marginal_ranks(tmp_path_factory):
    """Each of two ranks' results of the marginals jobs."""
    # about 37 s
    return run_group(2, [marginals_job(name) for name in MARGINAL_GRAPHS], tmp_path_factory.mktemp("marginals"),
                     timeout_s=110)


@pytest.mark.parametrize("name", MARGINAL_GRAPHS)
def test_sharded_marginals_match_reference_and_single_device(marginal_ranks, name):
    """``sharded_pose_marginals`` and ``sharded_landmark_marginals`` on two
    ranks at the graph's estimate: the same on both ranks, within 1e-7 of
    the reference's on a mesh of two CPU devices and of the port's
    single-device ``pose_marginal_covariances`` /
    ``landmark_marginal_covariances`` (all PCG at 1e-10).  Every S product
    is one psum, and the landmarks' B columns one more."""
    from pyslam_tpu.dist.schur_reduce import sharded_landmark_marginals as j_lm
    from pyslam_tpu.dist.schur_reduce import sharded_pose_marginals as j_pose
    from pyslam_tpu_torch.solver import covariance as tcov

    outs = [r[f"marginals_{name}"] for r in marginal_ranks]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["pose"], outs[0]["pose"])
        np.testing.assert_array_equal(o["landmarks"], outs[0]["landmarks"])
    ours = outs[0]
    jg = ARRAYS[name][0]
    mesh = j_make_mesh(2, axis_name="l")
    ref_pose = np.asarray(j_pose(jg, mesh, np.asarray(MARGINAL_POSES), **MARGINAL_PCG))
    ref_lm = np.asarray(j_lm(jg, mesh, np.asarray(MARGINAL_LANDMARKS), **MARGINAL_PCG))
    tg = graph_from_numpy(*ARRAYS[name][1], dtype=torch.float64, device="cpu")
    single_pose = tcov.pose_marginal_covariances(tg, indices=MARGINAL_POSES, **MARGINAL_PCG).numpy()
    single_lm = tcov.landmark_marginal_covariances(tg, MARGINAL_LANDMARKS, **MARGINAL_PCG).numpy()
    for got, refs in ((ours["pose"], (ref_pose, single_pose)), (ours["landmarks"], (ref_lm, single_lm))):
        for ref in refs:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7 * np.abs(ref).max())
    dp = tg.blocks["poses"].dof
    np.testing.assert_allclose(ours["pose"][0], np.eye(dp), atol=1e-10)  # the anchor's unit block
    assert ours["pose_collectives"]["psum"] > 1 and ours["lm_collectives"]["psum"] > 2
