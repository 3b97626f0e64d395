"""Posterior covariance of the torch port (``solver/covariance.py``) against
the JAX reference (``pyslam_tpu/solver/covariance.py``), in f64 on the CPU,
on graphs solved by the reference and carried across with
``graph_from_numpy``.  Every graph-level case of ``tests/test_covariance.py``
is mirrored (``TestCovariance``, ``TestSchurCovariance``,
``TestFullSlamCovariance``, ``TestDirectCovariance``, and the graph-level
computations behind its ``Problem`` cases), with the pose-pose coupling of
full-SLAM graphs, a self-loop coupling, anchors as unit blocks, both
S-solver methods and a landmark-first observation batch.

Tolerances, relative to the largest entry of the reference's answer:
1e-10 for the exact paths (the dense inverse, the multifrontal solves and
sweep, ``method="sparse"``: the same eliminations, sums in another order);
1e-7 for PCG at rtol 1e-10 (both sides stop within 1e-10 of the solution
in their own summation order; the condition numbers here are below 1e3).
Each port answer is also held to the port's own dense inverse at the same
tolerances.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import to_port

import pyslam_tpu.solver as jsolver
from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorBatch as JFactorBatch
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.graph.core import VariableBlock as JVariableBlock
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu_torch import solver as tsolver
from pyslam_tpu_torch.graph import FactorBatch, FactorGraph
from pyslam_tpu_torch.solver import covariance as tcov
from pyslam_tpu_torch.solver.cuda_ops import LAUNCHES, reset_launches
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64
EXACT, PCG = 1e-10, 1e-7
RTOL = 1e-10


def assert_rel(out, ref, rel):
    ref = np.asarray(ref)
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * np.abs(ref).max())


def _jopts(**kw):
    return jsolver.Options(**kw)


@functools.cache
def loop_graph(n_poses=25, n_loops=4, seed=2, method="lm", iters=30):
    """``tests/test_covariance.py``'s ``solved_graph`` (and its siblings):
    se2_loop solved by the reference."""
    g = jbuild.pose_graph(jsynth.se2_loop(n_poses=n_poses, n_loops=n_loops, seed=seed), dtype=F64)
    solved, _ = jsolver.solve(g, _jopts(method=method, max_iters=iters))
    return solved, to_port(solved)


def _between_batch(Ti, Tj, T_obs, scale=10.0):
    return JFactorBatch.create(
        kind="between_se3", slots=("poses", "poses"), indices=(np.asarray(Ti, np.int32), np.asarray(Tj, np.int32)),
        data={"T_obs": jnp.asarray(T_obs, F64),
              "sqrt_info": jnp.broadcast_to(scale * jnp.eye(6, dtype=F64), (len(Ti), 6, 6))},
        loss=JL2())


@functools.cache
def ba_graph(name):
    """The reference's BA test graphs, solved by its ``solve_schur``:
    'ba' (``TestSchurCovariance``), 'slam' (``TestFullSlamCovariance``: an
    odometry chain of between factors beside the observations), 'selfloop'
    ('slam' plus a between factor from pose 3 to itself) and 'anchored'
    (``test_problem_lazy_landmark_*``: 5 cameras, 20 points, poses 0 and 1
    constant)."""
    if name == "ba":
        g = jbuild.ba_graph(jsynth.ba_synthetic(n_cams=6, n_pts=40, obs_per_pt=4, seed=8), dtype=F64)
        solved, _ = jsolver.solve_schur(g, _jopts(method="lm", max_iters=25), mode="dense")
    elif name == "anchored":
        g = jbuild.ba_graph(jsynth.ba_synthetic(n_cams=5, n_pts=20, obs_per_pt=3, seed=6), dtype=F64)
        pb = g.blocks["poses"]
        const = np.zeros(5, bool)
        const[:2] = True
        g = JFactorGraph({**g.blocks, "poses": JVariableBlock.create("se3", pb.values, const)}, list(g.batches))
        solved, _ = jsolver.solve_schur(g, _jopts(method="lm", max_iters=25), mode="dense")
    else:
        data = jsynth.ba_synthetic(n_cams=8, n_pts=50, obs_per_pt=4, seed=12)
        g = jbuild.ba_graph(data, dtype=F64)
        Ti = np.arange(7)
        T_obs = np.stack([data.T_gt[j] @ np.linalg.inv(data.T_gt[i]) for i, j in zip(Ti, Ti + 1)])
        batches = [g.batches[0], _between_batch(Ti, Ti + 1, T_obs)]
        if name == "selfloop":
            rot = np.eye(4)
            rot[:3, :3] = np.array([[np.cos(0.1), -np.sin(0.1), 0], [np.sin(0.1), np.cos(0.1), 0], [0, 0, 1]])
            rot[:3, 3] = [0.05, -0.02, 0.01]
            batches.append(_between_batch([3], [3], rot[None], scale=3.0))
        g = JFactorGraph(dict(g.blocks), batches)
        solved, _ = jsolver.solve_schur(g, _jopts(method="lm", max_iters=25), mode="pcg", pcg_rtol=1e-12,
                                        pcg_max_iters=400)
    return solved, to_port(solved)


@functools.cache
def dense(name, kind):
    """(the reference's full_covariance, the port's) of a cached graph."""
    jg, tg = loop_graph() if kind == "loop" else ba_graph(name)
    return np.asarray(jsolver.full_covariance(jg)), tcov.full_covariance(tg).numpy()


def block_of(cov, g, name, i, j, name_j=None):
    off, offj = g.offsets()[name], g.offsets()[name_j or name]
    d, dj = g.blocks[name].dof, g.blocks[name_j or name].dof
    return cov[off + i * d: off + (i + 1) * d, offj + j * dj: offj + (j + 1) * dj]


# --------------------------------------------------------------------------
# TestCovariance: pose graphs, PCG column solves
# --------------------------------------------------------------------------


def test_full_covariance_matches_reference():
    jcov, tcov_ = dense(None, "loop")
    assert_rel(tcov_, jcov, EXACT)
    jg, tg = loop_graph()
    H = tsolver.assemble_dense(tg)[0].numpy()
    np.testing.assert_allclose(tcov_ @ H, np.eye(H.shape[0]), rtol=0, atol=1e-9)


def test_marginals_match_reference_and_dense_inverse():
    jg, tg = loop_graph()
    idx = [1, 7, 20]
    reset_launches()
    ours = tcov.marginal_covariances(tg, "poses", idx, pcg_rtol=RTOL)
    assert LAUNCHES["ell_pcg_plain"] == 1  # the 9 columns in one block
    assert_rel(ours, jsolver.marginal_covariances(jg, "poses", idx, pcg_rtol=RTOL), PCG)
    cov = dense(None, "loop")[1]
    for k, i in enumerate(idx):
        assert_rel(ours[k], block_of(cov, tg, "poses", i, i), PCG)


def test_spd_and_anchor():
    jg, tg = loop_graph()
    ours = tcov.marginal_covariances(tg, "poses", [0, 5])
    assert_rel(ours, jsolver.marginal_covariances(jg, "poses", [0, 5]), 1e-5)  # the default rtol 1e-8
    np.testing.assert_allclose(ours[0].numpy(), np.eye(3), atol=1e-8)  # the anchor's unit block
    assert (np.linalg.eigvalsh(ours[1].numpy()) > 0).all()


def test_all_marginals_in_blocks_of_columns():
    """Every pose: 75 columns, chunked on multiples of 3 (the CPU's chunk
    is the reference's 256 - 256 % d), against the reference."""
    jg, tg = loop_graph()
    ours = tcov.marginal_covariances(tg, pcg_rtol=RTOL)
    assert ours.shape == (25, 3, 3)
    assert_rel(ours, jsolver.marginal_covariances(jg, pcg_rtol=RTOL), PCG)


@pytest.mark.parametrize("graph,i,j", [("loop8", 3, 3), ("loop12", 3, 7), ("loop25", 2, 20)])
def test_covariance_block_matches_reference_and_dense(graph, i, j):
    """``test_problem_covariance_block`` (se2_loop(8, 2)) and
    ``test_problem_lazy_dispatch_no_dense`` (se2_loop(12, 3)) at the graph
    level: the block of the column solves against the dense inverse."""
    args = {"loop8": (8, 2, 1), "loop12": (12, 3, 4), "loop25": (25, 4, 2)}[graph]
    jg, tg = loop_graph(*args)
    ours = tcov.covariance_block(tg, i, j)
    assert_rel(ours, jsolver.covariance_block(jg, i, j), PCG)
    cov = tcov.full_covariance(tg).numpy()
    assert_rel(ours, block_of(cov, tg, "poses", i, j), PCG)
    if i == j:
        assert (np.linalg.eigvalsh(ours.numpy()) > 0).all()


# --------------------------------------------------------------------------
# TestDirectCovariance: the multifrontal factorization
# --------------------------------------------------------------------------


def test_direct_marginals_match_reference():
    jg, tg = loop_graph()
    idx = [1, 7, 20]
    ours = tcov.marginal_covariances_direct(tg, "poses", idx, leaf_size=8)
    assert_rel(ours, jsolver.marginal_covariances_direct(jg, "poses", idx, leaf_size=8), EXACT)
    cov = dense(None, "loop")[1]
    for k, i in enumerate(idx):
        assert_rel(ours[k], block_of(cov, tg, "poses", i, i), EXACT)


def test_direct_anchor_unit_block_and_all_marginals():
    jg, tg = loop_graph()
    ours = tcov.marginal_covariances_direct(tg, "poses", [0])
    np.testing.assert_allclose(ours[0].numpy(), np.eye(3), atol=1e-10)
    every = tcov.marginal_covariances_direct(tg)  # the selected-inverse sweep
    assert_rel(every, jsolver.marginal_covariances_direct(jg), EXACT)
    np.testing.assert_allclose(every[0].numpy(), np.eye(3), atol=1e-12)


def test_covariance_blocks_direct_match_reference():
    jg, tg = loop_graph()
    pairs = [(5, 6), (6, 5), (10, 10), (3, 4)]
    jd, jb = jsolver.covariance_blocks_direct(jg, pairs)
    td, tb = tcov.covariance_blocks_direct(tg, pairs)
    assert_rel(td, jd, EXACT)
    assert_rel(tb, jb, EXACT)
    cov = dense(None, "loop")[1]
    for (u, v), blk in zip(pairs, tb):
        assert_rel(blk, block_of(cov, tg, "poses", u, v), EXACT)


# --------------------------------------------------------------------------
# TestSchurCovariance / TestFullSlamCovariance: the reduced camera system
# --------------------------------------------------------------------------

BA_GRAPHS = ["ba", "slam", "selfloop"]
METHODS = ["pcg", "sparse"]


def _tol(method):
    return EXACT if method == "sparse" else PCG


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", BA_GRAPHS)
def test_pose_marginals_match_reference(name, method):
    jg, tg = ba_graph(name)
    idx = [1, 3, 5] if name == "ba" else [1, 4, 6]
    kw = dict(indices=idx, pcg_rtol=RTOL, method=method)
    ours = tcov.pose_marginal_covariances(tg, **kw)
    assert_rel(ours, jsolver.pose_marginal_covariances(jg, **kw), _tol(method))
    cov = dense(name, "ba")[1]
    for k, i in enumerate(idx):
        assert_rel(ours[k], block_of(cov, tg, "poses", i, i), _tol(method))
    # the anchor (pose 0): the unit block of the masking
    np.testing.assert_allclose(tcov.pose_marginal_covariances(tg, indices=[0], method=method)[0].numpy(),
                               np.eye(6), atol=1e-10)


@pytest.mark.parametrize("name", BA_GRAPHS)
def test_all_pose_marginals_by_the_sweep_over_S(name):
    """``method="sparse"`` with no indices: the selected inverse of the
    factored S."""
    jg, tg = ba_graph(name)
    ours = tcov.pose_marginal_covariances(tg, method="sparse")
    assert_rel(ours, jsolver.pose_marginal_covariances(jg, method="sparse"), EXACT)
    assert_rel(ours, tcov.pose_marginal_covariances(tg, pcg_rtol=RTOL), PCG)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", BA_GRAPHS)
def test_pose_cross_block_matches_reference(name, method):
    jg, tg = ba_graph(name)
    i, j = (2, 4) if name == "ba" else (2, 5)
    kw = dict(pcg_rtol=RTOL, method=method)
    ours = tcov.pose_covariance_block(tg, i, j, **kw)
    assert_rel(ours, jsolver.pose_covariance_block(jg, i, j, **kw), _tol(method))
    assert_rel(ours, block_of(dense(name, "ba")[1], tg, "poses", i, j), _tol(method))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", BA_GRAPHS)
def test_landmark_blocks_match_reference(name, method):
    """Landmark marginals (all the requested landmarks' B columns in one
    block of S-solves), landmark cross and diagonal blocks and a
    pose-landmark block."""
    jg, tg = ba_graph(name)
    kw = dict(pcg_rtol=RTOL, method=method)
    tol = _tol(method)
    cov = dense(name, "ba")[1]
    idx = [0, 7, 23] if name == "ba" else [5, 0, 17]
    ours = tcov.landmark_marginal_covariances(tg, idx, **kw)
    assert_rel(ours, jsolver.landmark_marginal_covariances(jg, idx, **kw), tol)
    for k, i in enumerate(idx):
        assert_rel(ours[k], block_of(cov, tg, "landmarks", i, i), tol)
    for i, j in [(3, 11), (7, 7), (5, 17)]:
        blk = tcov.landmark_covariance_block(tg, i, j, **kw)
        assert_rel(blk, jsolver.landmark_covariance_block(jg, i, j, **kw), tol)
        assert_rel(blk, block_of(cov, tg, "landmarks", i, j), tol)
    p, lm = (2, 7) if name == "ba" else (3, 5)
    blk = tcov.pose_landmark_covariance_block(tg, p, lm, **kw)
    assert_rel(blk, jsolver.pose_landmark_covariance_block(jg, p, lm, **kw), tol)
    assert_rel(blk, block_of(cov, tg, "poses", p, lm, "landmarks"), tol)


@pytest.mark.parametrize("method", METHODS)
def test_anchored_landmark_blocks(method):
    """``test_problem_lazy_landmark_marginal`` / ``_cross_block`` at the
    graph level: two constant poses, landmark blocks (3, 3) and (3, 9)."""
    jg, tg = ba_graph("anchored")
    cov = dense("anchored", "ba")[1]
    kw = dict(pcg_rtol=RTOL, method=method)
    for i, j in [(3, 3), (3, 9)]:
        blk = tcov.landmark_covariance_block(tg, i, j, **kw)
        assert_rel(blk, jsolver.landmark_covariance_block(jg, i, j, **kw), _tol(method))
        assert_rel(blk, block_of(cov, tg, "landmarks", i, j), _tol(method))
    marg = tcov.pose_marginal_covariances(tg, indices=[0, 1, 2], **kw)
    np.testing.assert_allclose(marg[:2].numpy(), np.broadcast_to(np.eye(6), (2, 6, 6)), atol=1e-10)


def test_unobserved_landmark_is_decoupled():
    """A landmark no camera sees: its masked unit block, zero cross blocks,
    as in the reference."""
    jg, tg = ba_graph("ba")
    keep = np.asarray(tg.batches[0].indices[1]) != 9  # drop every observation of landmark 9
    fb = tg.batches[0]
    tg2 = FactorGraph(dict(tg.blocks), [FactorBatch(
        fb.kind, fb.slots, tuple(i[torch.as_tensor(keep)] for i in fb.indices),
        {k: (v[torch.as_tensor(keep)] if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == fb.n else v)
         for k, v in fb.data.items()}, fb.loss, fb.weight[torch.as_tensor(keep)])])
    np.testing.assert_allclose(tcov.landmark_marginal_covariances(tg2, [9, 2])[0].numpy(), np.eye(3), atol=1e-12)
    assert not tcov.landmark_covariance_block(tg2, 9, 2).any()
    assert not tcov.pose_landmark_covariance_block(tg2, 1, 9).any()


@pytest.mark.parametrize("method", METHODS)
def test_landmark_first_batch_gives_the_same_covariances(method):
    """An observation batch whose slots are (landmarks, poses): the port's
    ``ba_assemble`` takes either order, so the covariances are those of the
    pose-first graph (the reference's ``ba_assemble`` reads slot 0 as the
    pose and does not take this order)."""
    _, tg = ba_graph("slam")
    fb, between = tg.batches
    flipped = FactorBatch("landmark_first_" + fb.kind, (fb.slots[1], fb.slots[0]), fb.indices[::-1], fb.data,
                          fb.loss, fb.weight)
    from pyslam_tpu_torch.graph.core import FACTOR_KERNELS

    FACTOR_KERNELS.setdefault(flipped.kind, _flip(FACTOR_KERNELS[fb.kind]))
    tl = FactorGraph(dict(tg.blocks), [flipped, between])
    kw = dict(pcg_rtol=RTOL, method=method)
    tol = _tol(method)
    assert_rel(tcov.pose_marginal_covariances(tl, indices=[1, 4], **kw),
               tcov.pose_marginal_covariances(tg, indices=[1, 4], **kw), tol)
    assert_rel(tcov.landmark_marginal_covariances(tl, [5, 17], **kw),
               tcov.landmark_marginal_covariances(tg, [5, 17], **kw), tol)
    assert_rel(tcov.pose_landmark_covariance_block(tl, 3, 5, **kw),
               tcov.pose_landmark_covariance_block(tg, 3, 5, **kw), tol)


def _flip(kernel):
    """A (landmark, pose) factor kernel from a (pose, landmark) one."""

    def flipped(data, X, T, compute_jacobians=True):
        r, jacs = kernel(data, T, X, compute_jacobians=compute_jacobians)
        return r, (jacs[::-1] if compute_jacobians else jacs)

    return flipped


def test_unknown_method_raises():
    _, tg = ba_graph("ba")
    with pytest.raises(ValueError, match="unknown S-solver method"):
        tcov.pose_marginal_covariances(tg, indices=[1], method="cholesky")
