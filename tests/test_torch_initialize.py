"""Pose-graph initialization of the torch port (``graph/initialize.py``, the
``chordal_rot`` / ``chordal_trans`` kinds, ``build.pose_graph(init=...)``)
against the JAX reference, in f64 on the CPU.

Tolerances: the chordal kinds' residuals and Jacobians 1e-10;
``spanning_tree_init`` (a copy, numpy) exact; ``chordal_init`` poses 1e-8;
graphs built from each init: the same arrays (1e-8), chi2 1e-8 relative;
solves from the chordal init: the same iteration counts and stop codes.

One pinned divergence: the reference defines a stage solver that takes the
dense path up to 12,000 dof and ``solve_ell(pcg_rtol=1e-6,
pcg_max_iters=250)`` above, and then calls ``solve_auto`` for both stages;
the port calls that stage solver.  Below 12,000 dof the two are one path
(every solve here).  Above, ``route_auto`` would send an SE(3)
translation stage to ``sparse_chol``; the port's stage goes to
``solve_ell``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph import initialize as jinit
from pyslam_tpu.graph.core import FACTOR_KERNELS as JK
from pyslam_tpu.graph.core import FactorBatch as JFactorBatch
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.graph.core import VariableBlock as JVariableBlock
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu.solver import route_auto as j_route_auto
from pyslam_tpu_torch.graph import build as tbuild
from pyslam_tpu_torch.graph import initialize as tinit
from pyslam_tpu_torch.graph.core import FACTOR_KERNELS as TK
from pyslam_tpu_torch.io import synth as tsynth
from pyslam_tpu_torch.solver import bcsr
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver import route_auto
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

CPU = dict(dtype=torch.float64, device="cpu")


def _rotations(rng, F, d):
    U, _, Vt = np.linalg.svd(rng.normal(size=(F, d, d)))
    return U @ Vt


@pytest.mark.parametrize("d", [2, 3])
def test_chordal_rot_matches_reference(d):
    rng = np.random.default_rng(d)
    F = 6
    R = _rotations(rng, F, d)
    x1, x2 = rng.normal(size=(F, d * d)), rng.normal(size=(F, d * d))
    rj, jj = JK["chordal_rot"]({"R_meas": jnp.asarray(R)}, jnp.asarray(x1), jnp.asarray(x2))
    rt, jt = TK["chordal_rot"]({"R_meas": torch.from_numpy(R)}, torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-10)
    for a, b in zip(jt, jj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)
    r_only, none = TK["chordal_rot"]({"R_meas": torch.from_numpy(R)}, torch.from_numpy(x1), torch.from_numpy(x2),
                                     compute_jacobians=False)
    assert none is None and torch.equal(r_only, rt)


@pytest.mark.parametrize("d", [2, 3])
def test_chordal_trans_matches_reference(d):
    rng = np.random.default_rng(10 + d)
    F = 5
    data = {"R_meas": _rotations(rng, F, d), "t_meas": rng.normal(size=(F, d))}
    t1, t2 = rng.normal(size=(F, d)), rng.normal(size=(F, d))
    rj, jj = JK["chordal_trans"]({k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(t1), jnp.asarray(t2))
    rt, jt = TK["chordal_trans"]({k: torch.from_numpy(v) for k, v in data.items()}, torch.from_numpy(t1),
                                 torch.from_numpy(t2))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-10)
    for a, b in zip(jt, jj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)


DATASETS = {
    "se2_loop_40": lambda m: m.se2_loop(n_poses=40, seed=5),
    "se2_loop_60_exact": lambda m: m.se2_loop(n_poses=60, odo_trans_std=1e-10, odo_rot_std=1e-10, seed=0),
    "se3_sphere_50_exact": lambda m: m.se3_sphere(n_poses=50, odo_trans_std=1e-10, odo_rot_std=1e-10, seed=0),
    "se3_sphere_120": lambda m: m.se3_sphere(n_poses=120, seed=2),
}


@pytest.fixture(scope="module")
def chordal_refs():
    """The reference's chordal_init of every dataset (the noise-free ones
    anchored at the ground truth's first pose), computed once."""
    out = {}
    for name, make in DATASETS.items():
        data = make(jsynth)
        kw = dict(T_anchor=data.T_gt[0]) if "exact" in name else {}
        out[name] = jinit.chordal_init(data.edges_i, data.edges_j, data.T_meas, data.T_gt.shape[0], **kw)
    return out


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_chordal_init_matches_reference(name, chordal_refs):
    data = DATASETS[name](tsynth)
    n = data.T_gt.shape[0]
    kw = dict(T_anchor=data.T_gt[0]) if "exact" in name else {}
    T0 = tinit.chordal_init(data.edges_i, data.edges_j, data.T_meas, n, device="cpu", **kw)
    assert T0.dtype == np.float64 and T0.shape == data.T_gt.shape
    np.testing.assert_allclose(T0, chordal_refs[name], rtol=0, atol=1e-8)
    R = T0[:, :data.dim, :data.dim]
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), np.broadcast_to(np.eye(data.dim), R.shape), atol=1e-10)
    if "exact" in name:  # the relaxation is exact on noise-free graphs
        np.testing.assert_allclose(T0, data.T_gt, atol=5e-5)
        np.testing.assert_allclose(T0[0], data.T_gt[0], atol=1e-12)


def test_spanning_tree_init_is_the_reference():
    for data in (tsynth.se2_loop(n_poses=30, seed=4), tsynth.se3_sphere(n_poses=40, seed=1)):
        n = data.T_gt.shape[0]
        ref = jinit.spanning_tree_init(data.edges_i, data.edges_j, data.T_meas, n, root=3)
        np.testing.assert_array_equal(tinit.spanning_tree_init(data.edges_i, data.edges_j, data.T_meas, n, root=3),
                                      ref)


@pytest.fixture(scope="module")
def init_solves():
    """The reference's graphs at each init of se2_loop(40) and
    se3_sphere(60), and its LM solve from the chordal init."""
    out = {}
    for key, data in (("se2", jsynth.se2_loop(n_poses=40, seed=5)), ("se3", jsynth.se3_sphere(n_poses=60, seed=7))):
        for init in ("spanning_tree", "chordal"):
            g = jbuild.pose_graph(data, dtype=jnp.float64, init=init)
            out[key, init] = g
        out[key, "solve"] = jlm.solve(out[key, "chordal"], jlm.Options(method="lm", max_iters=40))
    return out


@pytest.mark.parametrize("key", ["se2", "se3"])
@pytest.mark.parametrize("init", ["spanning_tree", "chordal"])
def test_pose_graph_init_matches_reference(key, init, init_solves):
    data = tsynth.se2_loop(n_poses=40, seed=5) if key == "se2" else tsynth.se3_sphere(n_poses=60, seed=7)
    g = tbuild.pose_graph(data, init=init, **CPU)
    ref = init_solves[key, init]
    np.testing.assert_allclose(g.blocks["poses"].values.numpy(), np.asarray(ref.blocks["poses"].values), rtol=0,
                               atol=1e-8)
    np.testing.assert_array_equal(g.blocks["poses"].const_mask.numpy(), np.asarray(ref.blocks["poses"].const_mask))
    np.testing.assert_allclose(g.chi2().item(), float(ref.chi2()), rtol=1e-8)
    if init == "chordal":
        assert g.chi2().item() < tbuild.pose_graph(data, **CPU).chi2().item()


@pytest.mark.parametrize("key", ["se2", "se3"])
def test_solve_from_the_chordal_init_matches_reference(key, init_solves):
    data = tsynth.se2_loop(n_poses=40, seed=5) if key == "se2" else tsynth.se3_sphere(n_poses=60, seed=7)
    solved, info = tlm.solve(tbuild.pose_graph(data, init="chordal", **CPU), tlm.Options(method="lm", max_iters=40))
    js, ji = init_solves[key, "solve"]
    assert (info.iterations, info.status) == (int(ji.iterations), int(ji.status))
    np.testing.assert_allclose(info.chi2.item(), float(ji.chi2), rtol=1e-8)
    np.testing.assert_allclose(solved.blocks["poses"].values.numpy(), np.asarray(js.blocks["poses"].values),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("init", ["chordal", "spanning_tree"])
def test_sim3_data_refuses_the_se_inits(init):
    with pytest.raises(ValueError, match="Sim"):
        tbuild.pose_graph(tsynth.sim3_loop(n_poses=10, n_loops=1, seed=0), init=init, **CPU)


def _stage_pair(stage, d, n):
    """The port's and the reference's chordal stage graph over a chain of
    n poses (shape only: built, never solved)."""
    rng = np.random.default_rng(n)
    ei, ej = np.arange(n - 1), np.arange(1, n)
    R = _rotations(rng, n - 1, d)
    if stage == "rot":
        tg = tinit._rotation_graph(ei, ej, R, n, 0, np.eye(d), **CPU)
        x0, data, kind = np.tile(np.eye(d).reshape(-1), (n, 1)), {"R_meas": R}, "chordal_rot"
    else:
        t = rng.normal(size=(n - 1, d))
        tg = tinit._translation_graph(ei, ej, R, t, n, 0, np.zeros(d), **CPU)
        x0, data, kind = np.zeros((n, d)), {"R_meas": R, "t_meas": t}, "chordal_trans"
    const = np.zeros(n, bool)
    const[0] = True
    name = "rot" if stage == "rot" else "t"
    jg = JFactorGraph(
        {name: JVariableBlock.create("euclidean", jnp.asarray(x0), const)},
        [JFactorBatch.create(kind=kind, slots=(name, name), indices=(ei, ej),
                             data={k: jnp.asarray(v) for k, v in data.items()}, loss=JL2())],
    )
    return tg, jg


# (stage, d, n): the rotation stage of SE(2) (4 dof a pose) and SE(3) (9),
# the translation stage of SE(2) (2) and SE(3) (3), on either side of the
# 12,000-dof ceiling
STAGES = [("rot", 2, 3000), ("rot", 2, 3001), ("rot", 3, 1333), ("rot", 3, 1334),
          ("trans", 2, 6000), ("trans", 2, 6001), ("trans", 3, 4000), ("trans", 3, 4001)]


@pytest.mark.parametrize("stage,d,n", STAGES)
def test_stage_solver_by_size(stage, d, n, monkeypatch):
    """The port's stage solver: ``solve_auto`` (the reference's route, here
    'dense') up to 12,000 dof, ``solve_ell`` with rtol 1e-6 / 250 CG
    iterations above.  Pinned divergence: above the ceiling the
    reference's ``solve_auto`` takes ``route_auto``'s route, which for an
    SE(3) translation stage is 'sparse_chol'."""
    tg, jg = _stage_pair(stage, d, n)
    assert route_auto(tg) == j_route_auto(jg)
    calls = []
    monkeypatch.setattr(bcsr, "solve_ell", lambda g, o, **kw: calls.append(("ell", kw)) or (g, None))
    monkeypatch.setattr("pyslam_tpu_torch.solver.solve_auto", lambda g, o: calls.append(("auto", {})) or (g, None))
    tinit._solve_stage(tg, tlm.Options(method="gn", max_iters=3), 1e-6, 250)
    if tg.total_dof <= tinit.STAGE_DENSE_DOF:
        assert calls == [("auto", {})] and j_route_auto(jg) == "dense"
    else:
        assert calls == [("ell", dict(pcg_rtol=1e-6, pcg_max_iters=250))]
        assert j_route_auto(jg) == ("sparse_chol" if (stage, d) == ("trans", 3) else "ell")


def test_block_jacobi_of_the_rotation_stage_gives_nan_where_cholesky_fails():
    """``sym_block_inv`` at the rotation stage's 9 x 9 blocks (and SE(2)'s
    4 x 4) takes its Cholesky branch: NaN blocks where the factorization
    fails, as the reference's Cholesky gives, the inverse elsewhere."""
    for d in (4, 9):
        bad = np.eye(d)
        bad[d - 1, d - 1] = -1.0
        D = torch.from_numpy(np.stack([2.0 * np.eye(d), bad]))
        out = bcsr.sym_block_inv(D)
        np.testing.assert_allclose(out[0].numpy(), 0.5 * np.eye(d), rtol=0, atol=1e-15)
        assert torch.isnan(out[1]).all()
