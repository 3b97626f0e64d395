"""Component-major landmark-sharded Schur bundle adjustment of the torch
port (``dist/schur_cm.py``) on gloo ranks spawned on the CPU, against the
JAX reference's ``solve_schur_cm`` on a mesh of as many of the conftest's
CPU devices, with the same landmark partition, in f64, on the same numpy
inputs: stereo BA, a Huber loss, and the reference's full-SLAM graph (an
odometry chain of between factors and a pose prior).

The ranks (1, 3, then 2 for the kill-one-host drill) are started once for
the module; each group runs its jobs and the tests read their results.
Tolerances: the same LM iterations, stop code and accept sequence (the
lambda of every LM iteration), the accepted costs and the final chi2
within 1e-9 relative, the values within 1e-8.  The same against the
port's single-device ``solve_schur`` (PCG 1e-10); 1e-9 between mesh sizes
and partitions; the same bits on every rank and for two solves.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_ranks import run_group, to_arrays

import pyslam_tpu.dist.schur_cm as j_schur_cm
from pyslam_tpu.dist import make_mesh as j_make_mesh
from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorBatch as JFactorBatch
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.io import bal as jbal
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.losses import HuberLoss as JHuber
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu.solver import Options as JOptions
from pyslam_tpu.solver import route_auto as j_route_auto
from pyslam_tpu_torch import dist
from pyslam_tpu_torch.graph import graph_from_numpy
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver import schur
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64


def _stereo(seed=3, loss=None):
    return jbuild.ba_graph(jsynth.ba_synthetic(n_cams=8, n_pts=64, seed=seed), loss=loss, dtype=F64)


def _full_slam():
    """The reference's ``TestCMFullSlam`` graph: observations, a between
    chain and a prior on camera 1."""
    data = jsynth.ba_synthetic(n_cams=8, n_pts=48, obs_per_pt=4, seed=12)
    g = jbuild.ba_graph(data, dtype=F64)
    Ti = np.arange(7, dtype=np.int32)
    T_obs = np.stack([data.T_gt[j] @ np.linalg.inv(data.T_gt[i]) for i, j in zip(Ti, Ti + 1)])
    between = JFactorBatch.create(kind="between_se3", slots=("poses", "poses"), indices=(Ti, Ti + 1),
                                  data={"T_obs": jnp.asarray(T_obs, F64),
                                        "sqrt_info": jnp.broadcast_to(10.0 * jnp.eye(6, dtype=F64), (7, 6, 6))},
                                  loss=JL2())
    pb = g.blocks["poses"]
    prior = JFactorBatch.create(kind="prior_se3", slots=("poses",), indices=(np.array([1], np.int32),),
                                data={"T_obs": jnp.asarray(np.asarray(pb.values[1:2]), F64),
                                      "sqrt_info": 1e2 * jnp.eye(6, dtype=F64)[None]},
                                loss=JL2())
    return JFactorGraph(dict(g.blocks), [g.batches[0], between, prior])


GRAPHS = {"stereo": lambda: _stereo(), "huber": lambda: _stereo(loss=JHuber(2.0)), "full_slam": _full_slam}
OPTIONS = dict(method="lm", max_iters=15)
PCG = dict(pcg_rtol=1e-10, pcg_max_iters=60, n_chunks=4)
# the reference's kill-one-host drill: 8 iterations at once, or 4, a
# checkpoint, and 4 more from it
CK = dict(pcg_rtol=1e-12, pcg_max_iters=60, n_chunks=2)
CK_FULL = dict(method="lm", max_iters=8, min_cost_decrease=1.0 - 1e-15)
CK_HALF = dict(method="lm", max_iters=4, min_cost_decrease=1.0 - 1e-15)
CK_GRAPH = "stereo"
# tests/test_host_loop.py::test_schur_cm: the solver's defaults, 12 LM iterations
DEFAULT_OPTIONS = dict(method="lm", max_iters=12)


def _graph(name):
    jg = GRAPHS[name]()
    return jg, to_arrays(jg)


ARRAYS = {name: _graph(name) for name in GRAPHS}
L_STEREO = ARRAYS["stereo"][0].blocks["landmarks"].n
RANDOM_PART = np.random.default_rng(0).integers(0, 3, L_STEREO)
EMPTY_RANK_PART = 1 + np.arange(L_STEREO) % 2  # rank 0 owns no landmark


def job(key, name, options=OPTIONS, **kw):
    return dict(key=key, solver="cm", graph=ARRAYS[name][1], options=options, kw={**PCG, **kw})


def jax_solve(name, n, monkeypatch=None, options=OPTIONS, **kw):
    """The reference's solve on n CPU devices; with ``monkeypatch``, its LM
    decisions recorded by wrapping its host loop."""
    import pyslam_tpu.solver.host_loop as j_host_loop

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
    solved, chi2, history = j_schur_cm.solve_schur_cm(ARRAYS[name][0], j_make_mesh(n, axis_name="l"),
                                                      JOptions(**options), **{**PCG, **kw})
    if monkeypatch is not None:
        monkeypatch.undo()
    values = {k: np.asarray(b.values) for k, b in solved.blocks.items()}
    return dict(chi2=chi2, history=history, values=values, **record)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: [each rank's results]}; the checkpoint files under
    ``tmp``.  The JAX package writes its checkpoint first."""
    tmp = tmp_path_factory.mktemp("schur_cm")
    ck3, jax_ck = str(tmp / "ck3.npz"), str(tmp / "jax.npz")
    jax_solve(CK_GRAPH, 3, options=CK_HALF, checkpoint_path=jax_ck, checkpoint_every=4, **CK)
    three = [job(name, name) for name in GRAPHS] + [
        job("stereo_again", "stereo"),
        job("random_part", "stereo", partition=RANDOM_PART),
        job("empty_rank", "stereo", partition=EMPTY_RANK_PART),
        dict(key="default", solver="cm", graph=ARRAYS["stereo"][1], options=DEFAULT_OPTIONS),
        dict(key="auto", solver="auto", graph=ARRAYS["stereo"][1], options=DEFAULT_OPTIONS,
             kw=dict(route="schur_cm", cm_obs_crossover=10)),
        job("ck_full", CK_GRAPH, CK_FULL, **CK),
        job("ck_write", CK_GRAPH, CK_HALF, checkpoint_path=ck3, checkpoint_every=4, **CK),
        job("ck_resume", CK_GRAPH, CK_HALF, checkpoint_path=ck3, resume=True, **CK),
        job("jax_resume", CK_GRAPH, CK_HALF, checkpoint_path=jax_ck, resume=True, **CK),
    ]
    # the three groups together take about 33 s
    out = {3: run_group(3, three, tmp, timeout_s=100)}
    # one host died: the checkpoint of three ranks resumes on two
    out[2] = run_group(2, [job("ck_resume", CK_GRAPH, CK_HALF, checkpoint_path=ck3, resume=True, **CK)], tmp,
                       timeout_s=100)
    out[1] = run_group(1, [job("stereo", "stereo"), job("stereo_again", "stereo")], tmp, timeout_s=100)
    return out, dict(ck3=ck3, jax_ck=jax_ck)


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
    """The reference's ``test_matches_single_device`` and
    ``test_between_and_prior_match_single_device``, against the port's
    ``solve_schur(mode="pcg")``."""
    tg = graph_from_numpy(*ARRAYS[name][1], dtype=torch.float64, device="cpu")
    solved, info = schur.solve_schur(tg, tlm.Options(**OPTIONS), mode="pcg", pcg_rtol=1e-10, pcg_max_iters=300)
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


def test_robust_loss_and_gauge(ranks):
    """The reference's ``test_robust_loss_and_gauge``: the Huber solve
    lowers its cost and camera 0, constant, does not move."""
    out = ranks[0][3][0]["huber"]
    assert out["chi2"] < out["history"][0]
    T0 = ARRAYS["huber"][1][0]["poses"]["values"][0]
    np.testing.assert_allclose(out["values"]["poses"][0], T0, rtol=0, atol=1e-12)


def test_default_budget_decreases_every_iteration(ranks):
    """``tests/test_host_loop.py::test_schur_cm``: at the defaults (PCG 1e-4
    / 30, 8 chunks) every accepted cost is below the one before."""
    hist = ranks[0][3][0]["default"]["history"]
    assert len(hist) > 2 and all(b < a for a, b in zip(hist, hist[1:]))


def test_collectives_per_iteration(ranks):
    """Per LM iteration: one sum for the cost and the camera blocks, one
    for g_red, one for D, one a CG iteration (the loop runs to its budget,
    its iterate frozen), one for the update norm and the trial cost: the
    count the module's docstring gives; one gather of the landmarks for
    the result."""
    for key, budget in (("stereo", PCG["pcg_max_iters"]), ("default", 30)):
        out = ranks[0][3][0][key]
        it = out["info"]["iterations"]
        assert out["collectives"] == {"psum": it * (4 + budget), "all_gather": 1}
    assert "4 + pcg_max_iters" in " ".join(dist.schur_cm.__doc__.split())


def test_solve_auto_takes_the_schur_cm_route(ranks):
    """With ``cm_obs_crossover`` lowered, ``solve_auto`` on three ranks
    takes the route the reference's ``route_auto`` names for the same graph
    on three devices, and solves through it: the bits of a direct
    ``solve_schur_cm`` at its defaults."""
    assert j_route_auto(ARRAYS["stereo"][0], mesh=j_make_mesh(3, axis_name="l"), cm_obs_crossover=10) == "schur_cm"
    auto, direct = ranks[0][3][0]["auto"], ranks[0][3][0]["default"]
    assert auto["history"] == direct["history"] and auto["lams"] == direct["lams"]
    for k in direct["values"]:
        np.testing.assert_array_equal(auto["values"][k], direct["values"][k])
    # solve_auto returns (solved, history): its chi2 here is the solved graph's
    np.testing.assert_allclose(auto["chi2"], direct["chi2"], rtol=1e-12)


def test_checkpoint_resume_is_exact(ranks):
    out = ranks[0][3][0]
    assert os.path.exists(ranks[1]["ck3"])
    np.testing.assert_allclose(out["ck_resume"]["chi2"], out["ck_full"]["chi2"], rtol=1e-9)
    np.testing.assert_allclose(out["ck_resume"]["history"][0], out["ck_write"]["history"][-1], rtol=1e-12)


def test_kill_one_host_drill(ranks):
    """Written by three ranks, resumed on two (new landmark shares)."""
    full, resumed = ranks[0][3][0]["ck_full"], ranks[0][2][0]["ck_resume"]
    assert resumed["history"][-1] <= resumed["history"][0]
    np.testing.assert_allclose(resumed["chi2"], full["chi2"], rtol=1e-9)


def test_checkpoint_keys_are_the_reference_s(ranks):
    ours, ref = np.load(ranks[1]["ck3"]), np.load(ranks[1]["jax_ck"])
    assert list(ours.keys()) == list(ref.keys()) == ["poses", "landmarks", "lam"]
    for k in ref.keys():
        assert ours[k].shape == ref[k].shape and ours[k].dtype == ref[k].dtype
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-9, atol=1e-10)


def test_a_checkpoint_of_the_jax_package_resumes_here(ranks):
    """The JAX package's checkpoint resumed by the port on three ranks ends
    at the chi2 of the JAX package's own resumed run, from the same start."""
    ref = jax_solve(CK_GRAPH, 3, options=CK_HALF, checkpoint_path=ranks[1]["jax_ck"], resume=True, **CK)
    ours = ranks[0][3][0]["jax_resume"]
    np.testing.assert_allclose(ours["chi2"], ref["chi2"], rtol=1e-9)
    np.testing.assert_allclose(ours["history"][0], ref["history"][0], rtol=1e-12)


def _cpu_mesh():
    return dist.Mesh(group=None, rank=1, size=3, device=torch.device("cpu"), backend="gloo", axis_name="l")


@pytest.mark.parametrize("case", ["bal9", "se2", "landmark_unary", "two_observation_batches"])
def test_refusals_raise_before_any_solve(case):
    """The reference's refusals (se3 poses with 3-dof landmarks only; one
    observation batch plus pose-unary and (pose, pose) batches, its
    ``assert``) are ValueError here, raised before a collective or a plan."""
    if case == "bal9":
        jg = jbuild.bal_graph(jbal.perturbed(jbal.synthetic_bal(n_cams=4, n_pts=20, seed=0)),
                              optimize_intrinsics=True, dtype=F64)
    elif case == "se2":
        jg = jbuild.landmark_slam_2d(jsynth.landmark_slam_2d(n_poses=10, n_landmarks=8, max_range=9.0, seed=1),
                                     dtype=F64)
    else:
        jg = ARRAYS["stereo"][0]
    tg = graph_from_numpy(*to_arrays(jg), dtype=torch.float64, device="cpu")
    if case == "landmark_unary":
        fb = tg.batches[0]
        extra = dataclasses.replace(fb, slots=("landmarks",), indices=(fb.indices[1],))
        tg = type(tg)(tg.blocks, [fb, extra])
    elif case == "two_observation_batches":
        tg = type(tg)(tg.blocks, [tg.batches[0], tg.batches[0]])
    match = "must be se3 poses" if case in ("bal9", "se2") else "one pose-landmark batch"
    with pytest.raises(ValueError, match=match):
        dist.shard_ba_cm(tg, _cpu_mesh())
    with pytest.raises(ValueError, match=match):
        dist.solve_schur_cm(tg, _cpu_mesh())


def test_rank_share_is_camera_sorted_and_whole():
    """A rank's share: its landmarks in graph order, their observations
    sorted stably by camera, and over the three ranks every observation
    once."""
    tg = graph_from_numpy(*ARRAYS["full_slam"][1], dtype=torch.float64, device="cpu")
    seen = []
    for rank in range(3):
        mesh = dist.Mesh(group=None, rank=rank, size=3, device=torch.device("cpu"), backend="gloo", axis_name="l")
        sb = dist.shard_ba_cm(tg, mesh, n_chunks=3)
        plan = sb.plan
        cam = plan.cam_idx.numpy()
        assert np.all(np.diff(cam) >= 0) and plan.C == 8 and len(plan.unary) == 2
        assert np.array_equal(sb.lms.numpy(), tg.blocks["landmarks"].values.numpy()[sb.lm_local])
        seen += list(zip(cam, sb.lm_local[plan.pt_idx.numpy()]))
    ci, li = (i.numpy() for i in tg.batches[0].indices)
    assert sorted(seen) == sorted(zip(ci, li))
