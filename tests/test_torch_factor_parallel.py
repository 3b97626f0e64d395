"""Factor-parallel solving of the torch port (``dist/factor_parallel.py``)
and the collectives of ``dist/mesh.py``, on gloo ranks spawned on the CPU,
against the JAX reference's ``solve_factor_parallel`` on a mesh of as
many of the conftest's CPU devices, in f64, on the same numpy inputs.

The ranks (1 and 3) are started once for the module; each runs every job
of ``JOBS`` and the tests below read their results.  Tolerances: the same
LM iterations, stop code and accept sequence (the lambda of every LM
iteration), the accepted costs and the final chi2 within 1e-9 relative,
the values within 1e-8; at two mesh sizes and against the single-device
``solve`` the same.  Every rank returns the same bits, and so do two
solves at one world size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_ranks import run_group, to_arrays

import pyslam_tpu.solver.host_loop as j_host_loop
from pyslam_tpu.dist import make_mesh as j_make_mesh
from pyslam_tpu.dist import pad_batch as j_pad_batch
from pyslam_tpu.dist import solve_factor_parallel as j_solve
from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import Options as JOptions
from pyslam_tpu.solver.assemble import assemble_dense as j_assemble_dense
from pyslam_tpu_torch import dist
from pyslam_tpu_torch.graph import FactorGraph, graph_from_numpy
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver import route_auto
from pyslam_tpu_torch.solver.assemble import assemble_dense
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64
WORLDS = (1, 3)
GRAPHS = {
    # the reference's graph (tests/test_factor_parallel.py)
    "sphere": lambda: jbuild.pose_graph(jsynth.se3_sphere(n_poses=40, n_loops=12, seed=5), dtype=F64),
    # two blocks and a camera in the batch's data: the route of a multi-block graph
    "ba": lambda: jbuild.ba_graph(jsynth.ba_synthetic(n_cams=6, n_pts=40, obs_per_pt=4, seed=8), dtype=F64),
}
# the reference's solve on n devices, for each graph and n held against it
REFERENCE_CASES = [("sphere", 1), ("sphere", 3), ("ba", 3)]
OPTIONS = dict(method="lm", max_iters=25)


def _graph(name):
    jg = GRAPHS[name]()
    return jg, to_arrays(jg)


ARRAYS = {name: _graph(name) for name in GRAPHS}
JOBS = [
    dict(key="mesh", solver="mesh"),
    *(dict(key=name, solver="factor", graph=ARRAYS[name][1], options=OPTIONS) for name in GRAPHS),
    dict(key="sphere_again", solver="factor", graph=ARRAYS["sphere"][1], options=OPTIONS),
]
# a 1-rank mesh takes the single-chip routes: solve_auto's mesh route needs more
AUTO = dict(key="sphere_auto", solver="auto", graph=ARRAYS["sphere"][1], options=OPTIONS,
            kw=dict(route="factor_parallel"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: [each rank's results]}."""
    tmp = tmp_path_factory.mktemp("factor_parallel")
    # every world together takes about 7 s
    return {n: run_group(n, JOBS + ([AUTO] if n > 1 else []), tmp, timeout_s=30) for n in WORLDS}


def jax_solve(monkeypatch, name, n):
    record = {"lams": []}
    loop = j_host_loop.host_lm_loop

    def recorded(step, state, options, on_accept=None):
        def rec(state, lam):
            record["lams"].append(lam)
            return step(state, lam)

        out = loop(rec, state, options, on_accept)
        record["info"] = out[2]
        return out

    monkeypatch.setattr(j_host_loop, "host_lm_loop", recorded)
    solved, chi2, history = j_solve(ARRAYS[name][0], j_make_mesh(n), JOptions(**OPTIONS))
    monkeypatch.undo()
    values = {k: np.asarray(b.values) for k, b in solved.blocks.items()}
    return dict(chi2=chi2, history=history, lams=record["lams"], info=record["info"], values=values)


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


@pytest.mark.parametrize("name,n", REFERENCE_CASES)
def test_matches_reference(ranks, monkeypatch, name, n):
    ours = ranks[n][0][name]
    assert_same_solve(ours, jax_solve(monkeypatch, name, n))
    assert ours["history"][-1] < 0.5 * ours["history"][0]


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_returns_the_same_solve(ranks, n):
    for name in GRAPHS:
        for other in ranks[n][1:]:
            assert_bits(other[name], ranks[n][0][name])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_matches_the_single_device_solve(ranks, name):
    tg = graph_from_numpy(*ARRAYS[name][1], dtype=torch.float64, device="cpu")
    solved, info = tlm.solve(tg, tlm.Options(**OPTIONS))
    for n in WORLDS:
        ours = ranks[n][0][name]
        assert len(ours["history"]) - 1 == int(info.accepted[: info.iterations].sum())
        np.testing.assert_allclose(ours["chi2"], info.chi2.item(), rtol=1e-9)
        for k, b in solved.blocks.items():
            np.testing.assert_allclose(ours["values"][k], b.values.numpy(), rtol=0, atol=1e-8)


def test_mesh_size_invariance(ranks):
    for name in GRAPHS:
        one, three = ranks[1][0][name], ranks[3][0][name]
        assert one["lams"] == three["lams"]
        np.testing.assert_allclose(three["history"], one["history"], rtol=1e-9)
        for k in one["values"]:
            np.testing.assert_allclose(three["values"][k], one["values"][k], rtol=0, atol=1e-9)


@pytest.mark.parametrize("n", WORLDS)
def test_two_solves_give_the_same_bits(ranks, n):
    assert_bits(ranks[n][0]["sphere_again"], ranks[n][0]["sphere"])


@pytest.mark.parametrize("n", WORLDS)
def test_collectives_per_iteration(ranks, n):
    """H, then g with chi2, then the trial cost: three sums an LM
    iteration, at every world size (no shortcut at 1), no gather."""
    out = ranks[n][0]["sphere"]
    assert out["collectives"] == {"psum": 3 * out["info"]["iterations"], "all_gather": 0}


def test_solve_auto_takes_the_factor_parallel_route(ranks):
    tg = graph_from_numpy(*ARRAYS["sphere"][1], dtype=torch.float64, device="cpu")
    mesh3 = dist.Mesh(group=None, rank=0, size=3, device=torch.device("cpu"), backend="gloo")
    assert route_auto(tg, mesh=mesh3) == "factor_parallel"
    assert_bits(ranks[3][0]["sphere_auto"], ranks[3][0]["sphere"])


@pytest.mark.parametrize("n", WORLDS)
def test_the_collectives(ranks, n):
    for rank, res in enumerate(ranks[n]):
        out = res["mesh"]
        assert (out["rank"], out["size"], out["backend"], out["axis_name"]) == (rank, n, "gloo", "f")
        np.testing.assert_array_equal(out["psum"], np.full(3, n * (n + 1) / 2))
        assert out["in_place"] and out["same_mesh"]
        expected = np.concatenate([np.full((r + 1, 2), float(r)) for r in range(n)])
        np.testing.assert_array_equal(out["gathered"], expected)
        np.testing.assert_array_equal(out["equal"], np.repeat(np.arange(n, dtype=np.float32), 2))
        assert out["collectives"] == {"psum": 1, "all_gather": 2}
        assert "holds 5 rows" in out["wrong_size"]
        assert f"the world has {n} ranks" in out["wrong_n"]


def test_pad_batch_is_inert():
    """The reference's ``test_pad_batch_inert``: the padded batch changes no
    cost, H or g; and it pads as the reference's does."""
    jg, arrays = ARRAYS["sphere"]
    tg = graph_from_numpy(*arrays, dtype=torch.float64, device="cpu")
    padded = dist.pad_batch(tg.batches[0], 16)
    assert padded.n % 16 == 0 and padded.n - tg.batches[0].n < 16
    assert dist.pad_batch(padded, 16) is padded
    tg2 = FactorGraph(tg.blocks, [padded])
    np.testing.assert_allclose(tg2.chi2().item(), tg.chi2().item(), rtol=1e-12)
    # the batched products of 112 and of 111 factors may round differently
    for a, b in zip(assemble_dense(tg2), assemble_dense(tg)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-14 * np.abs(b.numpy()).max())
    jpadded = j_pad_batch(jg.batches[0], 16)
    for a, b in zip(padded.indices, jpadded.indices):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(padded.weight.numpy(), np.asarray(jpadded.weight))
    for k, v in jpadded.data.items():
        np.testing.assert_array_equal(padded.data[k].numpy(), np.asarray(v))
    H_ref, g_ref, _ = j_assemble_dense(JFactorGraph(jg.blocks, [jpadded]))
    H, g, _ = assemble_dense(tg2)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_ref), rtol=0, atol=1e-10 * np.abs(np.asarray(H_ref)).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0, atol=1e-10 * np.abs(np.asarray(g_ref)).max())
