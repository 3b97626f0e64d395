"""The large Schur path on BAL's 9-parameter cameras (``bal_cam9``: SE(3) x
[f, k1, k2], the ``reprojection_bal9`` factor), in f64 on the CPU.

The JAX package's ``prepare_large_ba`` takes ``se3`` cameras only and its
``route_auto`` sends a large ``bal_cam9`` graph to the generic Schur PCG
(PARITY.md), so a 9-dof solve of ``solve_schur_large`` is held to the same
optimum as the small Schur path of both packages (``solve_schur``, dense
mode) on the same graph, and to the benchmark's plain reference
(``portbench/references/ba9_schur_lm.py``) on a seeded ``bal_scene9``
problem, step for step.  Tolerances: the optimum's chi2 within 1e-9
relative, cameras and landmarks within 1e-7 relative (the solvers converge
to the same point by different LM paths); against the reference, which runs
the same algorithm, every accepted cost within 1e-9.

Also: ``bal_rows_plain``'s 90 rows against the chunked ``reprojection_bal9``
path, the route of a 9-dof plan through ``bal_rows``, the wrapper's
refusals, ``linear="dense"`` and ``precond="cluster"`` / ``"stale"`` at
9 dof, ``route_auto`` past the gate, and the spans a 9-dof solve fills."""

import dataclasses
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import to_port

from portbench.arith import Arith
from portbench.entries import schur_large_bal9 as bal9_entry
from portbench.generators import bal_scene9
from portbench.references import ba9_schur_lm
from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.io import bal as jbal
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu.solver.schur import solve_schur as j_solve_schur
from pyslam_tpu_torch import observability as obs
from pyslam_tpu_torch.graph import FactorGraph
from pyslam_tpu_torch.graph.core import FACTOR_KERNELS, FactorBatch, VariableBlock, register_factor
from pyslam_tpu_torch.losses import CauchyLoss, HuberLoss, L1Loss, L2Loss, TDistributionLoss, TukeyLoss
from pyslam_tpu_torch.solver import cuda_ops, route_auto
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver import schur_large as tsl
from pyslam_tpu_torch.solver.linear import HOST_READS, reset_host_reads
from pyslam_tpu_torch.solver.schur import solve_schur
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64


@pytest.fixture(autouse=True, scope="module")
def _unload_compiled_programs():
    yield
    jax.clear_caches()


@register_factor("reprojection_bal9_landmark_first")
def _bal9_landmark_first_kernel(data, lm, cam, compute_jacobians=True):
    r, jacs = FACTOR_KERNELS["reprojection_bal9"](data, cam, lm, compute_jacobians=compute_jacobians)
    return r, (jacs[::-1] if compute_jacobians else None)


# --------------------------------------------------------------------------
# Graphs (reference first, then carried across)
# --------------------------------------------------------------------------


def _bal9(anchor, seed=0):
    """A perturbed ``synthetic_bal(6, 50)`` with every camera's intrinsics
    off by 1% in f and by noise in k1 and k2, as 9-dof cameras: camera 0
    held by ``bal_graph``'s pose prior (``prior_balcam_pose``, its
    intrinsics free), or frozen whole by the constant mask (no prior)."""
    data = jbal.perturbed(jbal.synthetic_bal(n_cams=6, n_pts=50, seed=seed))
    rng = np.random.default_rng(seed + 3)
    intr = np.array(data.intrinsics, dtype=np.float64)
    intr[:, 0] *= 1 + 0.01 * rng.standard_normal(len(intr))
    intr[:, 1:] += [1e-8, 1e-15] * rng.standard_normal((len(intr), 2))
    if anchor == "mask":
        intr[0] = data.intrinsics[0]
    data = jbal.BALData(data.T, intr, data.pts, data.cam_idx, data.pt_idx, data.obs)
    g = jbuild.bal_graph(data, dtype=F64, optimize_intrinsics=True, anchor_first=anchor == "prior")
    if anchor == "mask":
        pb = g.blocks["poses"]
        g = type(g)({**g.blocks, "poses": dataclasses.replace(pb, const_mask=pb.const_mask.at[0].set(True))},
                    g.batches)
    return g


@functools.lru_cache(maxsize=None)
def graphs(anchor):
    jg = _bal9(anchor)
    return jg, to_port(jg)


def landmark_first(graph):
    return FactorGraph(graph.blocks, [
        dataclasses.replace(fb, kind=fb.kind + "_landmark_first", slots=fb.slots[::-1], indices=fb.indices[::-1])
        if fb.slots == ("poses", "landmarks") else fb for fb in graph.batches])


# the benchmark configuration's scene at its test sizes
_CONFIG = json.loads((pathlib.Path(__file__).resolve().parents[1] / "portbench" / "configs" /
                      "bal_final13682.json").read_text())
SIZES = {**_CONFIG["sizes"], **_CONFIG["test_sizes"]}

OPTS = dict(method="lm", max_iters=40, min_cost_decrease=1.0 - 1e-12)
LARGE = dict(n_chunks=4, pcg_rtol=1e-12, pcg_max_iters=200)


def _assert_same_optimum(chi2, solved, ref_chi2, ref_poses, ref_lms):
    np.testing.assert_allclose(chi2, ref_chi2, rtol=1e-9)
    np.testing.assert_allclose(solved.blocks["poses"].values.numpy(), np.asarray(ref_poses), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(solved.blocks["landmarks"].values.numpy(), np.asarray(ref_lms), rtol=1e-7,
                               atol=1e-9)


# --------------------------------------------------------------------------
# Against the small Schur path of both packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("order", ["pose_first", "landmark_first"])
@pytest.mark.parametrize("anchor", ["prior", "mask"])
def test_matches_the_small_schur_path_of_both_packages(anchor, order):
    jg, tg = graphs(anchor)
    j_solved, j_info = j_solve_schur(jg, jlm.Options(**OPTS), mode="dense")
    t_solved, t_info = solve_schur(tg, tlm.Options(**OPTS), mode="dense")
    g = tg if order == "pose_first" else landmark_first(tg)
    plan = tsl.prepare_large_ba(g, 4)
    assert (plan.dp, plan.pose_kind, plan.rows.shape[0], plan.bal) == (9, "bal_cam9", 90, order == "pose_first")
    solved, chi2, history = tsl.solve_schur_large(g, tlm.Options(**OPTS), plan=plan, **LARGE)
    assert history[-1] < 0.01 * history[0]
    for ref in ((float(j_info.chi2), j_solved), (float(t_info.chi2), t_solved)):
        _assert_same_optimum(chi2, solved, ref[0], ref[1].blocks["poses"].values, ref[1].blocks["landmarks"].values)
    # a frozen camera stays where it was, its intrinsics too
    mask = tg.blocks["poses"].const_mask
    assert torch.equal(solved.blocks["poses"].values[mask], tg.blocks["poses"].values[mask])


def test_slot_order_changes_no_bit():
    """The observation batch's slot order (the chunked factor kernel) gives
    the bits of the pose-first plan (``bal_rows``' twin over the same
    chunks)."""
    _, tg = graphs("prior")
    a = tsl.solve_schur_large(tg, tlm.Options(method="lm", max_iters=6), n_chunks=3)
    b = tsl.solve_schur_large(landmark_first(tg), tlm.Options(method="lm", max_iters=6), n_chunks=3)
    assert a[2] == b[2]
    for n in ("poses", "landmarks"):
        assert torch.equal(a[0].blocks[n].values, b[0].blocks[n].values)


# --------------------------------------------------------------------------
# Against the benchmark's plain reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_matches_the_plain_reference(seed, monkeypatch):
    """``portbench``'s entry on a seeded ``bal_scene9`` problem at the
    configuration's test sizes, in f64, against ``ba9_schur_lm`` in f64:
    the same accepted costs, iteration for iteration, and the same point."""
    cfg = dict(_CONFIG, dtype="float64", solver=dict(_CONFIG["solver"], n_chunks=16))
    problem = bal_scene9.generate(SIZES, seed, "cpu")
    state = bal9_entry.build(problem, cfg, "cpu")
    bal9_entry.plan(state)
    histories = []
    real = tsl.host_lm_loop_speculative

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        histories.append(out[1])
        return out

    monkeypatch.setattr(tsl, "host_lm_loop_speculative", recording)
    answer = bal9_entry.solve(state)
    ref = ba9_schur_lm.solve(problem, cfg, Arith())
    assert ref["iterations"] == cfg["options"]["max_iters"] and all(accepted for accepted, _ in ref["history"])
    np.testing.assert_allclose(histories[-1][1:], [c for _, c in ref["history"]], rtol=1e-9)
    np.testing.assert_allclose(answer["chi2"], ref["chi2"], rtol=1e-9)
    gaps = ba9_schur_lm.distances(answer, ref)
    moved = ba9_schur_lm.distances(ref, ba9_schur_lm.start(problem))
    assert float(gaps.max()) <= 1e-7 * float(moved.max())
    assert float(ba9_schur_lm.cost(problem, answer, Arith())) == pytest.approx(answer["chi2"], rel=1e-9)


def test_the_generator_draws_the_intrinsics_start_from_the_seed():
    sizes = dict(SIZES, n_pts=300, n_obs=1200)
    a, b, c = (bal_scene9.generate(sizes, s, "cpu") for s in (5, 5, 6))
    assert torch.equal(a["intrinsics_init"], b["intrinsics_init"])
    assert not torch.equal(a["intrinsics_init"], c["intrinsics_init"])
    true, init = a["intrinsics"], a["intrinsics_init"]
    assert torch.equal(init[0], true[0]) and bool((init[1:] != true[1:]).all())
    rel = (init[1:, 0] / true[1:, 0] - 1).abs()
    assert float(rel.max()) < 0.05 and float((init[1:, 1:] - true[1:, 1:]).abs().max()) < 0.05


# --------------------------------------------------------------------------
# bal_rows on 9-parameter cameras (its plain twin here)
# --------------------------------------------------------------------------

BAL_LOSSES = {
    "l2": L2Loss(), "l1": L1Loss(), "cauchy": CauchyLoss(2.0), "huber": HuberLoss(1.0), "tukey": TukeyLoss(3.0),
    "student_t": TDistributionLoss(5.0, 1.5),
}


def _port_bal9(loss=None, per_obs_info=False, seed=0):
    """The mask-anchored graph on the port with another loss, random weights
    and, with ``per_obs_info``, one random sqrt_info an observation."""
    _, g = graphs("mask")
    (fb,) = g.batches
    rng = np.random.default_rng(seed + 7)
    data = dict(fb.data)
    if per_obs_info:
        info = np.zeros((fb.n, 2, 2))
        info[:, [0, 1], [0, 1]] = rng.uniform(0.5, 1.5, size=(fb.n, 2))
        info[:, 0, 1] = rng.uniform(-0.3, 0.3, size=fb.n)
        data["sqrt_info"] = torch.from_numpy(info)
    weight = torch.from_numpy(rng.uniform(0.5, 2.0, size=fb.n))
    return FactorGraph(g.blocks, [dataclasses.replace(fb, data=data, weight=weight, loss=loss or L2Loss())])


def _bal_args(plan):
    return tsl.bal_rows_args(plan, plan.poses, plan.lms)


def _assert_rows_close(out, ref, rel):
    assert out.shape == ref.shape
    scale = ref.abs().amax(0).clamp(min=1e-300)
    assert ((out - ref).abs() <= rel * scale).all(), ((out - ref).abs() / scale).max().item()


@pytest.mark.parametrize("n_chunks", [1, 7])
@pytest.mark.parametrize("info", ["shared", "per_observation"])
@pytest.mark.parametrize("loss", sorted(BAL_LOSSES))
def test_bal_rows_plain_matches_the_chunked_path(loss, info, n_chunks):
    """``bal_rows_plain`` over the whole axis gives the chunked
    ``reprojection_bal9`` path's cost and 90 rows within 1e-12 of each
    column's largest entry at every loss the kernel takes; the cost-only
    pass its cost; the plan's route the chunked path's bits."""
    g = _port_bal9(BAL_LOSSES[loss], per_obs_info=info == "per_observation")
    plan = tsl.prepare_large_ba(g, n_chunks)
    assert plan.bal and plan.dp == 9
    args = _bal_args(plan)
    assert args[0].shape == (6, 19) and args[5:8] == (None, None, None)
    chunked = dataclasses.replace(plan, bal=False)
    cost, rows = tsl._obs_rows(chunked, plan.poses, plan.lms)
    assert rows.shape == (plan.M, 90)
    t_cost, t_rows = cuda_ops.bal_rows_plain(*args, plan.loss)
    _assert_rows_close(t_rows, rows, 1e-12)
    _assert_rows_close(t_cost[:, None], cost[:, None], 1e-12)
    only, none = cuda_ops.bal_rows_plain(*args, plan.loss, rows=False)
    assert none is None and torch.equal(only, t_cost)
    r_cost, r_rows = tsl._obs_rows(plan, plan.poses, plan.lms)
    assert torch.equal(r_cost, cost) and torch.equal(r_rows, rows)
    # the scale of a difference: at least each column's largest entry
    rows_scale, cost_scale = cuda_ops.bal_rows_scale(*args, plan.loss)
    assert rows_scale.shape == (90,) and bool((rows_scale >= rows.abs().amax(0) * (1 - 1e-12)).all())
    assert float(cost_scale) >= float(cost.abs().max()) * (1 - 1e-12)


def test_the_rows_are_the_joint_jacobians_products():
    """``rows_of(9)``: the camera's 9 gradient and 45 upper Hessian rows,
    the landmark's 3 and 6, and W's 27, as positions of the joint 12-column
    [g | H]; ``rows_of(6)`` is the 54 rows of the se3 camera; the plan and
    the kernel's wrapper read the one table."""
    assert tsl.rows_of is cuda_ops.rows_of
    r9, r6 = tsl.rows_of(9), tsl.rows_of(6)
    assert len(r9) == 90 and len(set(r9.tolist())) == 90 and len(r6) == 54
    se3 = (list(range(6)) + [9 + 9 * i + j for i in range(6) for j in range(i, 6)] + [6, 7, 8]
           + [9 + 9 * i + j for i in range(6, 9) for j in range(i, 9)]
           + [9 + 9 * i + j for i in range(6) for j in range(6, 9)])
    assert r6.tolist() == se3  # the 6-dof layout bal_rows' 54 rows have always had
    assert tsl.camera_width(9) == 54 and tsl.camera_width(6) == 27
    assert r9[:9].tolist() == list(range(9)) and r9[54:57].tolist() == [9, 10, 11]
    assert r9[9] == 12 and r9[-1] == 12 + 12 * 8 + 11  # H[0, 0] and W[8, 2]


@pytest.mark.parametrize("speculative", [True, False])
def test_bal_rows_route(speculative):
    """A 9-dof ``reprojection_bal9`` plan linearizes and costs through
    ``bal_rows`` (its twin here), one call a linearization or cost-only
    pass, and never through the kernel on the CPU."""
    g = _port_bal9(CauchyLoss(2.0), per_obs_info=True)
    plan = tsl.prepare_large_ba(g, 4)
    cuda_ops.reset_launches()
    calls = {"lin": 0, "cost": 0}
    linearize, cost = tsl._linearize, tsl._cost

    def counted(what, fn):
        def call(*a):
            calls[what] += 1
            return fn(*a)
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsl, "_linearize", counted("lin", linearize))
        mp.setattr(tsl, "_cost", counted("cost", cost))
        _, chi2, hist = tsl.solve_schur_large(g, tlm.Options(method="lm", max_iters=4), plan=plan,
                                              speculative=speculative)
    assert chi2 < hist[0] and calls["lin"] > 1 and (calls["cost"] > 0) == (not speculative)
    assert cuda_ops.LAUNCHES["bal_rows_plain"] == calls["lin"] + calls["cost"]
    assert cuda_ops.LAUNCHES["bal_rows"] == cuda_ops.LAUNCHES["bal_rows9"] == 0


def test_bal_rows_refuses_a_camera_without_its_intrinsics():
    """Cameras (C, 19) carry f, k1, k2, so a call that passes them too is
    refused, as is a (C, 4, 4) pose table without them, and a loss the
    kernel does not evaluate."""
    plan = tsl.prepare_large_ba(_port_bal9(), 4)
    args = list(_bal_args(plan))
    M = plan.M
    with pytest.raises(ValueError, match="poses"):
        cuda_ops.bal_rows(*args[:5], *(torch.ones(M, dtype=torch.float64),) * 3, *args[8:], L2Loss())
    T = args[0][:, :16].reshape(-1, 4, 4).contiguous()
    with pytest.raises(ValueError, match="poses"):
        cuda_ops.bal_rows(T, *args[1:], L2Loss())
    with pytest.raises(ValueError, match="does not evaluate"):
        cuda_ops.bal_rows(*args, TDistributionLoss(5.0))
    with pytest.raises(TypeError, match="lms"):
        cuda_ops.bal_rows(args[0], args[1].float(), *args[2:], L2Loss())


# --------------------------------------------------------------------------
# The linear solves at 9 dof, the route, the spans
# --------------------------------------------------------------------------


@pytest.mark.parametrize("linear,kw", [("dense", {}), ("pcg", dict(precond="cluster", cluster_size=4)),
                                       ("pcg", dict(precond="cluster", cluster_size=6)),
                                       ("pcg", dict(precond="stale", stale_refresh=2))],
                         ids=["dense", "cluster4", "cluster6", "stale2"])
def test_the_other_linear_solves_take_9_dof(linear, kw):
    """``linear="dense"`` and the cluster and stale-S preconditioners read
    the camera's dof from the plan: (9 C, 9 C) S, (9 G, 9 G) cluster
    blocks; each reaches the Jacobi PCG optimum."""
    _, tg = graphs("prior")
    opts = tlm.Options(**OPTS)
    _, c_jacobi, _ = tsl.solve_schur_large(tg, opts, **LARGE)
    budget = {} if linear == "dense" else dict(pcg_rtol=1e-12, pcg_max_iters=60)
    _, chi2, hist = tsl.solve_schur_large(tg, opts, n_chunks=4, linear=linear, **budget, **kw)
    assert hist[-1] < 0.01 * hist[0]
    np.testing.assert_allclose(chi2, c_jacobi, rtol=1e-9)


def _bal9_of_size(n_obs, n_cams=10, obs_per_pt=5):
    """A bal_cam9 graph of ``n_obs`` observations on the CPU: cheap to build,
    never solved."""
    n_pts = -(-n_obs // obs_per_pt)
    cams = torch.zeros(n_cams, 19)
    cams[:, :16] = torch.eye(4).reshape(16)
    cams[:, 16] = 500.0
    blocks = {"poses": VariableBlock.create("bal_cam9", cams),
              "landmarks": VariableBlock.create("euclidean", torch.zeros(n_pts, 3))}
    idx = torch.arange(n_obs)
    batch = FactorBatch.create("reprojection_bal9", ("poses", "landmarks"), (idx % n_cams, idx // obs_per_pt),
                               {"obs": torch.zeros(n_obs, 2), "sqrt_info": torch.eye(2)}, L2Loss())
    return FactorGraph(blocks, [batch])


@pytest.mark.parametrize("n_obs,large", [(2_000_001, True), (2_000_000, False)])
def test_route_schur_large_for_bal_cam9(n_obs, large):
    """Past 2,000,000 observations a bal_cam9 graph takes the large Schur
    path, as an se3 one does; at the gate it does not."""
    route = route_auto(_bal9_of_size(n_obs))
    assert (route == "schur_large") == large


@pytest.mark.parametrize("speculative", [True, False], ids=["speculative", "cost_pass"])
def test_a_9_dof_solve_fills_each_span(speculative):
    """The spans of the large Schur path, as a 6-dof solve fills them
    (``tests/test_torch_spans.py``)."""
    _, tg = graphs("mask")
    obs.reset_spans()
    reset_host_reads()
    tsl.solve_schur_large(tg, tlm.Options(method="lm", max_iters=4), n_chunks=4, speculative=speculative)
    calls, reads = dict(obs.SPAN_CALLS), sum(HOST_READS.values())
    n = calls["lm.iteration"]
    lin = n + 1 if speculative else n
    assert calls == {"solve": 1, "plan": 1, "lm.iteration": n, "schur.linearize": lin, "schur.linearize.rows": lin,
                     "schur.linearize.sums": lin, "schur.linearize.parts": lin, "schur.reduce": n, "schur.pcg": n,
                     "schur.back_substitute": n, "read": reads}
    assert n >= 2 and all(obs.SPAN_NS[k] > 0 for k in calls)
