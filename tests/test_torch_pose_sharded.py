"""Variable-sharded pose-graph solving of the torch port
(``dist/pose_sharded.py``) on gloo ranks spawned on the CPU, against the
JAX reference's ``solve_pose_sharded`` on a mesh of as many of the
conftest's CPU devices, with the same BFS partition, in f64, on the same
numpy inputs: SE(2) and SE(3) pose graphs, a unary prior anchoring a
graph without a frozen pose, and a graph of priors only.  And
the longer-x form of ``ell_matvec`` that the sharded product runs, in its
plain version, against the reference's local product.

The ranks (1, 3, then 2 for the kill-one-host drill) are started once for
the module.  Tolerances: the same LM iterations, stop code and accept
sequence, the accepted costs and the final chi2 within 1e-9 relative, the
values within 1e-8; the same against the port's ``solve_ell`` (``solve``
for the graph of priors); 1e-9 between mesh sizes and partitions; the
same bits on every rank and for two solves.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_ranks import run_group, to_arrays

import pyslam_tpu.dist.pose_sharded as j_pose_sharded
from pyslam_tpu.dist import make_mesh as j_make_mesh
from pyslam_tpu.dist import solve_pose_sharded as j_solve
from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorBatch as JFactorBatch
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.graph.core import VariableBlock as JVariableBlock
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.lie import se2 as jse2
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu.solver import Options as JOptions
from pyslam_tpu_torch import dist
from pyslam_tpu_torch.graph import graph_from_numpy
from pyslam_tpu_torch.solver import bcsr, cuda_ops
from pyslam_tpu_torch.solver import lm as tlm
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64


def _loop(seed=0, loss=None, anchor_first=True):
    return jbuild.pose_graph(jsynth.se2_loop(n_poses=40, n_loops=6, seed=seed), loss=loss, dtype=F64,
                             anchor_first=anchor_first)


def _prior():
    """Every pose free, the graph anchored by a stiff SE(2) prior (the
    reference's ``test_unary_prior_batch``)."""
    g = _loop(seed=3, anchor_first=False)
    prior = JFactorBatch.create(
        kind="prior_se2", slots=("poses",), indices=(np.array([0], np.int32),),
        data={"T_obs": jnp.asarray(np.asarray(g.blocks["poses"].values[:1]), F64),
              "sqrt_info": 1e3 * jnp.eye(3, dtype=F64)[None]},
        loss=g.batches[0].loss)
    return JFactorGraph(dict(g.blocks), [g.batches[0], prior])


def _prior_only(n=24):
    """No edge at all: every ELL block is diagonal (``TestUnaryOnlyGraph``)."""
    rng = np.random.default_rng(0)
    targets = np.asarray(jse2.exp(jnp.asarray(rng.normal(0, 0.3, (n, 3)))))
    blocks = {"poses": JVariableBlock.create("se2", jnp.asarray(np.tile(np.eye(3), (n, 1, 1)), F64))}
    prior = JFactorBatch.create(
        kind="prior_se2", slots=("poses",), indices=(np.arange(n, dtype=np.int32),),
        data={"T_obs": jnp.asarray(targets, F64), "sqrt_info": jnp.broadcast_to(jnp.eye(3, dtype=F64), (n, 3, 3))},
        loss=JL2())
    return JFactorGraph(blocks, [prior])


GRAPHS = {
    "se2": lambda: _loop(),
    "se3": lambda: jbuild.pose_graph(jsynth.se3_sphere(n_poses=60, seed=0), dtype=F64),
    "prior": _prior,
    "prior_only": _prior_only,
}
OPTIONS = dict(method="lm", max_iters=15)
# above what these graphs need at this tolerance (schur_large.cg_iterations()
# reads it): the port's loop runs to its budget, its iterate frozen
PCG = dict(pcg_rtol=1e-8, pcg_max_iters=140)
CK_FULL = dict(method="lm", max_iters=6, min_cost_decrease=1.0 - 1e-15)
CK_HALF = dict(method="lm", max_iters=3, min_cost_decrease=1.0 - 1e-15)
AUTO_OPTIONS = dict(method="lm", max_iters=2)


def _graph(name):
    jg = GRAPHS[name]()
    return jg, to_arrays(jg)


ARRAYS = {name: _graph(name) for name in GRAPHS}
RANDOM_PART = np.random.default_rng(0).integers(0, 3, 40)


def job(key, name, options=OPTIONS, **kw):
    return dict(key=key, solver="pose", graph=ARRAYS[name][1], options=options, kw={**PCG, **kw})


def jax_solve(monkeypatch, name, n):
    record = {"lams": []}
    loop = j_pose_sharded.host_lm_loop

    def recorded(step, state, options, on_accept=None):
        def rec(state, lam):
            record["lams"].append(lam)
            return step(state, lam)

        out = loop(rec, state, options, on_accept)
        record["info"] = out[2]
        return out

    monkeypatch.setattr(j_pose_sharded, "host_lm_loop", recorded)
    solved, chi2, history = j_solve(ARRAYS[name][0], j_make_mesh(n, axis_name="p"), JOptions(**OPTIONS), **PCG)
    monkeypatch.undo()
    return dict(chi2=chi2, history=history, values={"poses": np.asarray(solved.blocks["poses"].values)}, **record)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: [each rank's results]}; the checkpoint paths."""
    tmp = tmp_path_factory.mktemp("pose_sharded")
    ck3, bare = str(tmp / "ck3.npz"), str(tmp / "bare.ck")
    three = [job(name, name) for name in GRAPHS] + [
        job("se2_again", "se2"),
        job("random_part", "se2", partition=RANDOM_PART),
        job("ck_full", "se2", CK_FULL),
        job("ck_write", "se2", CK_HALF, checkpoint_path=ck3, checkpoint_every=3),
        job("bare_write", "se2", CK_HALF, checkpoint_path=bare, checkpoint_every=3),
        job("bare_resume", "se2", CK_HALF, checkpoint_path=bare, resume=True),
        # solve_auto runs the solver's default PCG budget
        dict(key="se2_default_pcg", solver="pose", graph=ARRAYS["se2"][1], options=AUTO_OPTIONS),
        dict(key="auto", solver="auto", graph=ARRAYS["se2"][1], options=AUTO_OPTIONS,
             kw=dict(route="pose_sharded", force=True)),
    ]
    # the three groups together take about 35 s
    out = {3: run_group(3, three, tmp, timeout_s=105)}
    # one host died: the checkpoint of three ranks resumes on two
    out[2] = run_group(2, [job("ck_resume", "se2", CK_HALF, checkpoint_path=ck3, resume=True)], tmp, timeout_s=105)
    out[1] = run_group(1, [job("se2", "se2"), job("se2_again", "se2")], tmp, timeout_s=105)
    return out, dict(ck3=ck3, bare=bare)


def assert_same_solve(ours, ref, rel=1e-9, state=1e-8):
    assert (ours["info"]["iterations"], ours["info"]["status"]) == (ref["info"]["iterations"], ref["info"]["status"])
    np.testing.assert_allclose(ours["lams"], ref["lams"], rtol=1e-12)  # the accept sequence
    assert len(ours["history"]) == len(ref["history"])
    # a cost below the rounding of the start's (the graph of priors reaches
    # 1e-30) has no relative digits
    floor = 1e-16 * ref["history"][0]
    np.testing.assert_allclose(ours["history"], ref["history"], rtol=rel, atol=floor)
    np.testing.assert_allclose(ours["chi2"], ref["chi2"], rtol=rel, atol=floor)
    np.testing.assert_allclose(ours["values"]["poses"], ref["values"]["poses"], rtol=0, atol=state)


def assert_bits(a, b):
    assert a["history"] == b["history"] and a["lams"] == b["lams"] and a["chi2"] == b["chi2"]
    np.testing.assert_array_equal(a["values"]["poses"], b["values"]["poses"])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_matches_reference_on_three_ranks(ranks, monkeypatch, name):
    ours = ranks[0][3][0][name]
    assert_same_solve(ours, jax_solve(monkeypatch, name, 3))
    assert ours["history"][-1] < ours["history"][0]


def test_matches_reference_on_one_rank(ranks, monkeypatch):
    assert_same_solve(ranks[0][1][0]["se2"], jax_solve(monkeypatch, "se2", 1))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_matches_the_single_device_solve(ranks, name):
    tg = graph_from_numpy(*ARRAYS[name][1], dtype=torch.float64, device="cpu")
    if name == "prior_only":
        solved, info = tlm.solve(tg, tlm.Options(**OPTIONS))
    else:
        solved, info = bcsr.solve_ell(tg, tlm.Options(**OPTIONS), **PCG)
    ours = ranks[0][3][0][name]
    assert len(ours["history"]) - 1 == int(info.accepted[: info.iterations].sum())
    np.testing.assert_allclose(ours["chi2"], info.chi2.item(), rtol=1e-9, atol=1e-16 * ours["history"][0])
    np.testing.assert_allclose(ours["values"]["poses"], solved.blocks["poses"].values.numpy(), rtol=0, atol=1e-8)


def test_every_rank_returns_the_same_solve(ranks):
    for group in ranks[0].values():
        for key in group[0]:
            for other in group[1:]:
                assert_bits(other[key], group[0][key])


@pytest.mark.parametrize("n", [1, 3])
def test_two_solves_give_the_same_bits(ranks, n):
    assert_bits(ranks[0][n][0]["se2_again"], ranks[0][n][0]["se2"])


def test_mesh_size_and_partition_invariance(ranks):
    ref = ranks[0][1][0]["se2"]
    for ours in (ranks[0][3][0]["se2"], ranks[0][3][0]["random_part"]):
        assert ours["lams"] == ref["lams"]
        np.testing.assert_allclose(ours["history"], ref["history"], rtol=1e-9)
        np.testing.assert_allclose(ours["values"]["poses"], ref["values"]["poses"], rtol=0, atol=1e-9)


def test_gauge_anchor_stays_fixed(ranks):
    T0 = ARRAYS["se2"][1][0]["poses"]["values"][0]
    np.testing.assert_allclose(ranks[0][3][0]["se2"]["values"]["poses"][0], T0, rtol=0, atol=1e-12)


def test_the_local_product_is_ell_matvec(ranks):
    """Every CG iteration's product is one ``ell_matvec`` call (here its
    plain version: CPU tensors), behind one gather of x; per LM iteration
    the two gathers of the poses and one sum of the costs, and two sums a
    CG iteration plus one before the first; one gather for the result."""
    out = ranks[0][3][0]["se2"]
    it, cg = out["info"]["iterations"], PCG["pcg_max_iters"]
    assert out["launches"]["ell_matvec_plain"] == it * cg and out["launches"]["ell_matvec"] == 0
    assert out["collectives"] == {"psum": it * (2 + 2 * cg), "all_gather": it * (2 + cg) + 1}


def test_solve_auto_runs_the_pose_sharded_route(ranks):
    """The route given (a graph past the ELL budget is too large here),
    ``solve_auto`` runs ``solve_pose_sharded`` on the mesh."""
    assert_bits(ranks[0][3][0]["auto"], ranks[0][3][0]["se2_default_pcg"])


def test_kill_one_host_drill(ranks):
    """Written by three ranks, resumed on two (a new BFS partition)."""
    full, resumed = ranks[0][3][0]["ck_full"], ranks[0][2][0]["ck_resume"]
    assert os.path.exists(ranks[1]["ck3"]) and resumed["history"][-1] <= resumed["history"][0]
    np.testing.assert_allclose(resumed["chi2"], full["chi2"], rtol=1e-9)
    ck = np.load(ranks[1]["ck3"])
    assert list(ck.keys()) == ["values", "lam"] and ck["values"].shape == (40, 3, 3)


def test_checkpoint_path_without_npz_suffix(ranks):
    assert os.path.exists(ranks[1]["bare"] + ".npz") and not os.path.exists(ranks[1]["bare"])
    np.testing.assert_allclose(ranks[0][3][0]["bare_resume"]["chi2"], ranks[0][3][0]["ck_full"]["chi2"], rtol=1e-9)


def test_copies_of_cut_factors_are_bounded():
    """Each factor is copied onto the owners of its poses: at most twice,
    and with a BFS partition of a loop graph, few more copies than
    factors (the reference's ``test_plan_duplication_is_bounded``)."""
    tg = graph_from_numpy(*ARRAYS["se2"][1], dtype=torch.float64, device="cpu")
    n_copies = 0
    for rank in range(4):
        mesh = dist.Mesh(group=None, rank=rank, size=4, device=torch.device("cpu"), backend="gloo", axis_name="p")
        sp = dist.shard_pose_graph(tg, mesh)
        n_copies += sum(int((b.weight > 0).sum()) for b in sp.batches)
        assert sp.cols.dtype == torch.int32 and int(sp.cols.max()) < sp.nb
    n_factors = sum(fb.n for fb in tg.batches)
    assert n_factors <= n_copies < 1.5 * n_factors


@pytest.mark.parametrize("nb,n_x,K,d", [(5, 12, 3, 3), (7, 7, 4, 6), (1, 30, 9, 6), (0, 4, 2, 3)])
def test_ell_matvec_takes_a_longer_x(nb, n_x, K, d):
    """A rank's rows against the x of every rank: ``ell_matvec`` (its
    plain version, on CPU tensors) against the reference's local product,
    ``einsum("rkij,rkj->ri", He_d, xf[cols_l])``
    (``pyslam_tpu/dist/pose_sharded.py:380-382``)."""
    rng = np.random.default_rng(nb + 10 * n_x)
    He = rng.normal(size=(nb, K, d, d))
    cols = rng.integers(0, n_x, size=(nb, K)).astype(np.int32)
    x = rng.normal(size=n_x * d)
    ref = np.asarray(jnp.einsum("rkij,rkj->ri", jnp.asarray(He), jnp.asarray(x).reshape(n_x, d)[cols])).reshape(-1)
    cuda_ops.reset_launches()
    out = cuda_ops.ell_matvec(torch.from_numpy(He), torch.from_numpy(cols), torch.from_numpy(x))
    assert cuda_ops.LAUNCHES["ell_matvec_plain"] == 1 and out.shape == (nb * d,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12 * max(np.abs(ref).max(initial=0.0), 1.0))


def test_ell_matvec_refuses_an_x_of_another_block_size():
    He = torch.zeros((2, 2, 3, 3), dtype=torch.float64)
    cols = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="n_x"):
        cuda_ops.ell_matvec(He, cols, torch.zeros(7, dtype=torch.float64))
