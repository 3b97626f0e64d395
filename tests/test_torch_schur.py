"""The Schur-complement path of the torch port (``solver/schur.py``) against
the JAX reference, in f64 on the CPU, on graphs built by the reference's
builders from numpy seeds and carried across with ``graph_from_numpy``:
stereo bundle adjustment (``ba_synthetic(8, 60, seed=3)``), the full-SLAM
graph of the reference's own Schur tests (observations and an odometry
chain), BAL graphs with fixed and with optimized intrinsics, 2D landmark
SLAM in both observation types, and a graph made to reach every branch of
``ba_assemble`` (a second frozen camera, an unobserved landmark, a camera
that sees one landmark twice, pose and landmark priors with padding, a
(pose, pose) batch with a repeated pair).

Tolerances:
  * ``ba_assemble`` parts, g and chi2: 1e-10 relative to the largest entry
    (the port sums each destination in plan order, XLA in scatter order);
  * one step: ``schur_solve_dense`` against the port's monolithic
    ``_dense_solve`` rtol 1e-6 / atol 1e-8 and ``schur_solve_pcg`` rtol
    1e-5 / atol 1e-7 (the reference's own tolerances), and both against the
    JAX step to 1e-8 relative to the largest entry;
  * ``solve_schur``: the same iteration count, status and accept sequence,
    chi2 within 1e-9 relative;
  * ``profile_port.pcg_solve_masked`` (the CG loop with its stop test on the
    device, which the profile times against the plain loop): the iterate
    and iteration count of ``pcg_solve`` (1e-12 relative) for every read
    interval, the JAX count too.
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import assert_rel as _assert_rel
from test_torch_assembly import to_port

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorBatch as JFactorBatch
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.graph.core import VariableBlock as JVariableBlock
from pyslam_tpu.io import bal as jbal
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.losses import HuberLoss as JHuber
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu.solver import linear as jlin
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu.solver import schur as jschur
from pyslam_tpu_torch.graph import FactorGraph
from pyslam_tpu_torch.solver import assemble as tas
from pyslam_tpu_torch.solver import linear as tlin
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.solver import schur as tschur
from pyslam_tpu_torch.solver.cuda_ops import LAUNCHES, reset_launches
from pyslam_tpu_torch.solver.linear import HOST_READS, reset_host_reads

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import profile_port  # noqa: E402  (the repository root's script, for its masked CG loop)
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F64 = jnp.float64


def assert_rel(out, ref, rel=1e-10):
    """Equal shapes, and entries within ``rel`` of the largest reference
    entry; an empty array has only its shape to compare."""
    if np.asarray(ref).size == 0:
        assert tuple(out.shape) == np.asarray(ref).shape
    else:
        _assert_rel(out, ref, rel)


def _stereo(loss=None):
    return jbuild.ba_graph(jsynth.ba_synthetic(n_cams=8, n_pts=60, seed=3), loss=loss, dtype=F64)


def _between(kind, i, j, T_obs, scale):
    d = T_obs.shape[-1] - 1
    dof = {2: 3, 3: 6}[d]
    return JFactorBatch.create(
        kind=kind, slots=("poses", "poses"), indices=(np.asarray(i, np.int32), np.asarray(j, np.int32)),
        data={"T_obs": jnp.asarray(T_obs, F64),
              "sqrt_info": jnp.broadcast_to(scale * jnp.eye(dof, dtype=F64), (len(i), dof, dof))},
        loss=JL2(),
    )


def _slam():
    """Observations and an odometry chain between consecutive poses in one
    graph (the reference's full-SLAM Schur test)."""
    data = jsynth.ba_synthetic(n_cams=8, n_pts=50, obs_per_pt=4, seed=12)
    g = jbuild.ba_graph(data, dtype=F64)
    i = np.arange(7)
    T_obs = np.stack([data.T_gt[b] @ np.linalg.inv(data.T_gt[a]) for a, b in zip(i, i + 1)])
    return JFactorGraph(dict(g.blocks), [g.batches[0], _between("between_se3", i, i + 1, T_obs, 10.0)])


def _bal(optimize_intrinsics):
    data = jbal.perturbed(jbal.synthetic_bal(n_cams=5, n_pts=40, seed=7))
    return jbuild.bal_graph(data, dtype=F64, optimize_intrinsics=optimize_intrinsics)


def _lm2d(obs_type):
    data = jsynth.landmark_slam_2d(n_poses=40, n_landmarks=25, max_range=8.0, obs_type=obs_type, seed=3)
    return jbuild.landmark_slam_2d(data, dtype=F64)


def _every_branch():
    """Every branch of ``ba_assemble``: cameras 0 and 3 frozen, landmark 40
    unobserved, landmark 5 frozen, camera 2 sees landmark 7 twice, a padded
    pose prior, a padded landmark prior, and a (pose, pose) batch in which
    the pair (1, 2) comes twice and one factor touches a frozen camera."""
    data = jsynth.ba_synthetic(n_cams=6, n_pts=40, seed=5)
    g = jbuild.ba_graph(data, loss=JHuber(2.0), dtype=F64)
    (fb,) = g.batches
    ci, li = (np.asarray(i) for i in fb.indices)
    twice = np.flatnonzero((ci == 2))[:1]
    fb = dataclasses.replace(
        fb,
        indices=(jnp.asarray(np.concatenate([ci, ci[twice]])), jnp.asarray(np.concatenate([li, li[twice]]))),
        data={**fb.data, "obs": jnp.concatenate([fb.data["obs"], fb.data["obs"][twice] + 0.5])},
        weight=jnp.concatenate([fb.weight, jnp.ones(1, F64)]),
    )
    poses, lms = g.blocks["poses"], g.blocks["landmarks"]
    const_p = np.asarray(poses.const_mask).copy()
    const_p[3] = True
    const_l = np.zeros(41, bool)
    const_l[5] = True
    blocks = {
        "poses": JVariableBlock(poses.kind, poses.values, jnp.asarray(const_p)),
        "landmarks": JVariableBlock(
            lms.kind, jnp.concatenate([lms.values, jnp.asarray([[0.3, -0.2, 6.0]], F64)]), jnp.asarray(const_l)),
    }
    idx = np.array([1, 4, 3], np.int32)
    pose_prior = JFactorBatch.create(
        kind="prior_se3", slots=("poses",), indices=(idx,),
        data={"T_obs": jnp.asarray(data.T_gt[idx], F64),
              "sqrt_info": jnp.broadcast_to(3.0 * jnp.eye(6, dtype=F64), (3, 6, 6))},
        loss=JL2(), weight=jnp.asarray([1.0, 0.0, 1.0]),
    )
    lidx = np.array([0, 9, 9, 5], np.int32)
    lm_prior = JFactorBatch.create(
        kind="prior_euclidean", slots=("landmarks",), indices=(lidx,),
        data={"obs": jnp.asarray(data.pts_gt[lidx], F64),
              "sqrt_info": jnp.broadcast_to(0.5 * jnp.eye(3, dtype=F64), (4, 3, 3))},
        loss=JL2(), weight=jnp.asarray([1.0, 1.0, 0.0, 1.0]),
    )
    i, j = np.array([1, 1, 2, 4]), np.array([2, 2, 3, 5])
    T_obs = np.stack([data.T_gt[b] @ np.linalg.inv(data.T_gt[a]) for a, b in zip(i, j)])
    return JFactorGraph(blocks, [fb, pose_prior, lm_prior, _between("between_se3", i, j, T_obs, 4.0)])


def _priors_only():
    """No observation and no (pose, pose) factor at all: W and PP are empty."""
    g = _every_branch()
    return JFactorGraph(dict(g.blocks), [g.batches[1], g.batches[2]])


GRAPHS = {
    "stereo": _stereo,
    "slam": _slam,
    "bal": lambda: _bal(False),
    "bal9": lambda: _bal(True),
    "lm2d_bearing_range": lambda: _lm2d("bearing_range"),
    "lm2d_xy": lambda: _lm2d("xy"),
    "every_branch": _every_branch,
    "priors_only": _priors_only,
}


@functools.cache
def graphs(name):
    """(reference graph, the port's graph of it), built once a test run."""
    jg = GRAPHS[name]()
    return jg, to_port(jg)


@functools.cache
def reference_parts(name):
    """The reference's ``ba_assemble`` of a graph, computed once a test run."""
    return jax.jit(jschur.ba_assemble)(graphs(name)[0])


# --------------------------------------------------------------------------
# Assembly
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ba_assemble_matches_reference(name):
    jg, tg = graphs(name)
    parts_j, g_j, chi2_j = reference_parts(name)
    parts_t, g_t, chi2_t = tschur.ba_assemble(tg)
    for key in ("Hpp", "Hll", "W", "PP", "g_p", "g_l"):
        assert_rel(parts_t[key], parts_j[key])
    for key in ("cam_idx", "pt_idx", "pp_i", "pp_j"):
        assert parts_t[key].dtype == torch.int64
        np.testing.assert_array_equal(parts_t[key].numpy(), np.asarray(parts_j[key]))
    assert parts_t["pose_first"] is bool(parts_j["pose_first"])
    assert_rel(g_t, g_j)
    assert_rel(chi2_t, chi2_j)
    # the gradient is the dense path's, and a second assembly over the same
    # plan gives the same bits
    g_dense, chi2_dense = tas.gradient_and_chi2(tg)
    assert_rel(g_t, g_dense)
    assert_rel(chi2_t, chi2_dense)
    again, g_again, _ = tschur.ba_assemble(tg, plan=parts_t["plan"])
    assert all(torch.equal(again[k], parts_t[k]) for k in ("Hpp", "Hll", "W", "PP")) and torch.equal(g_again, g_t)


def test_ba_assemble_masks_constants_and_dead_landmarks():
    _, tg = graphs("every_branch")
    parts, g, _ = tschur.ba_assemble(tg)
    eye6, eye3 = torch.eye(6, dtype=torch.float64), torch.eye(3, dtype=torch.float64)
    for c in (0, 3):  # frozen cameras
        assert torch.equal(parts["Hpp"][c], eye6) and not parts["g_p"][c].any()
        assert not parts["W"][parts["cam_idx"] == c].any()
    for l in (5, 40):  # frozen, unobserved
        assert torch.equal(parts["Hll"][l], eye3) and not parts["g_l"][l].any()
        assert not parts["W"][parts["pt_idx"] == l].any()
    touches_frozen = (parts["pp_i"] == 3) | (parts["pp_j"] == 3)
    assert touches_frozen.any() and not parts["PP"][touches_frozen].any()
    assert parts["PP"][~touches_frozen].abs().sum() > 0
    assert g.shape == (41 * 3 + 6 * 6,)  # 'landmarks' sorts before 'poses'
    assert parts["pose_first"] is False


def test_segment_sums_go_through_slot_reduce():
    """Every sum of the Schur path is a ``slot_reduce`` call (on CPU tensors
    its plain version): four an assembly with observations, pose factors
    and landmark factors, and per product of the implicit S two for the
    observations and two for the (pose, pose) factors."""
    _, tg = graphs("every_branch")
    plan = tschur.schur_plan(tg)
    reset_launches()
    parts, g, _ = tschur.ba_assemble(tg, plan=plan)
    assert LAUNCHES["slot_reduce_plain"] == 4 and LAUNCHES["slot_reduce"] == 0
    opt = tlm.Options(method="lm")
    lam = torch.tensor(1e-4, dtype=torch.float64)
    reset_launches()
    tschur.schur_solve_dense(parts, g, lam, opt)
    # g_red, the (camera, landmark) pairs, the S blocks of PP, back substitution
    assert LAUNCHES["slot_reduce_plain"] == 4
    reset_launches()
    reset_host_reads()
    tschur.schur_solve_pcg(parts, g, lam, opt, rtol=0.0, max_iters=3)
    # g_red, the preconditioner, (1 + 3) products of four sums, back substitution
    assert LAUNCHES["slot_reduce_plain"] == 2 + 4 * 4 + 1
    assert HOST_READS["pcg"] == 3 and HOST_READS["lm"] == 0  # one read a CG iteration


BAD_GRAPHS = {
    # (landmark, pose) is taken since the sparse Schur path (an observation
    # batch in the other slot order); a (landmark, landmark) batch is not
    "slots": (lambda fb: dataclasses.replace(fb, slots=("landmarks", "landmarks"), indices=fb.indices[::-1]),
              "unsupported slot pattern"),
    "camera_index": (lambda fb: dataclasses.replace(fb, indices=(fb.indices[0].clone().fill_(8), fb.indices[1])),
                     "out of range"),
    "landmark_index": (lambda fb: dataclasses.replace(fb, indices=(fb.indices[0], fb.indices[1] - 1)),
                       "out of range"),
}


@pytest.mark.parametrize("case", sorted(BAD_GRAPHS))
def test_schur_plan_rejects(case):
    """The reference clamps an out-of-range index silently; the port
    refuses it, as ``dense_plan`` does."""
    _, tg = graphs("stereo")
    change, message = BAD_GRAPHS[case]
    bad = FactorGraph(tg.blocks, [change(tg.batches[0])])
    with pytest.raises(ValueError, match=message):
        tschur.schur_plan(bad)
    with pytest.raises(ValueError, match=message):
        tschur.solve_schur(bad)
    with pytest.raises(ValueError, match="unknown Schur mode"):
        tschur.solve_schur(tg, mode="sparse")


# --------------------------------------------------------------------------
# One step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["stereo", "bal", "bal9", "slam", "every_branch", "lm2d_xy"])
def test_one_step_matches_monolithic_and_reference(name):
    """Eliminating the landmarks gives the step of the full system (block
    damping has the diagonal of ``lam * diag(H)``), and the reference's."""
    jg, tg = graphs(name)
    opts_t, opts_j = tlm.Options(method="lm"), jlm.Options(method="lm")
    parts, grad, chi2 = tschur.ba_assemble(tg)
    H, grad_d, chi2_d = tas.assemble_dense(tg)
    np.testing.assert_allclose(chi2.item(), chi2_d.item(), rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), grad_d.numpy(), rtol=1e-9, atol=1e-9)

    lam = torch.tensor(1e-4, dtype=torch.float64)
    dx_dense = tlm._dense_solve(H, grad_d, lam, opts_t).numpy()
    dx_schur = tschur.schur_solve_dense(parts, grad, lam, opts_t)
    dx_pcg = tschur.schur_solve_pcg(parts, grad, lam, opts_t, rtol=1e-12, max_iters=500)
    np.testing.assert_allclose(dx_schur.numpy(), dx_dense, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(dx_pcg.numpy(), dx_dense, rtol=1e-5, atol=1e-7)

    parts_j, grad_j, _ = reference_parts(name)
    lam_j = jnp.asarray(1e-4, F64)
    assert_rel(dx_schur, jschur.schur_solve_dense(parts_j, grad_j, lam_j, opts_j), 1e-8)
    assert_rel(dx_pcg, jschur.schur_solve_pcg(parts_j, grad_j, lam_j, opts_j, rtol=1e-12, max_iters=500), 1e-8)


@pytest.mark.parametrize("method", ["lm", "gn"])
def test_one_step_without_observations(method):
    """Empty W and PP (no sum has a contribution): the step is the block
    solves of the priors, in both modes."""
    jg, tg = graphs("priors_only")
    parts, grad, _ = tschur.ba_assemble(tg)
    parts_j, grad_j, _ = reference_parts("priors_only")
    assert parts["W"].shape == (0, 6, 3) and parts["PP"].shape == (0, 6, 6)
    lam = torch.tensor(1e-3, dtype=torch.float64)
    ref = jschur.schur_solve_dense(parts_j, grad_j, jnp.asarray(1e-3, F64), jlm.Options(method=method))
    opt = tlm.Options(method=method)
    assert_rel(tschur.schur_solve_dense(parts, grad, lam, opt), ref, 1e-10)
    assert_rel(tschur.schur_solve_pcg(parts, grad, lam, opt, rtol=1e-12, max_iters=50), ref, 1e-10)


def test_damp_blocks_matches_reference():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(7, 3, 3))
    H = A @ A.transpose(0, 2, 1)
    H[2] = 0.0  # the floor
    assert_rel(tschur._damp_blocks(torch.from_numpy(H), 0.3), jschur._damp_blocks(jnp.asarray(H), 0.3), 1e-14)


# --------------------------------------------------------------------------
# Failed factorizations
# --------------------------------------------------------------------------


@pytest.mark.parametrize("block", ["Hll", "Hpp"])
@pytest.mark.parametrize("mode", ["dense", "pcg"])
def test_failed_factorization_gives_a_nan_step_and_a_rejected_iteration(mode, block):
    """An indefinite ``Hll`` block (the batched factorization), or ``Hpp``
    block (the dense S, the block preconditioner), gives a NaN step as the
    reference's ``jnp.linalg.cholesky`` does: no exception, and the LM loop
    rejects the step and goes on."""
    jg, tg = graphs("stereo")
    parts, grad, _ = tschur.ba_assemble(tg)
    bad = dict(parts)
    bad[block] = parts[block].clone()
    bad[block][2] = -torch.eye(parts[block].shape[-1], dtype=torch.float64)
    lam = torch.tensor(1e-4, dtype=torch.float64)
    opt = tlm.Options(method="lm", max_iters=6)
    solve_step = {"dense": tschur.schur_solve_dense, "pcg": tschur.schur_solve_pcg}[mode]
    dx = solve_step(bad, grad, lam, opt)
    assert torch.isnan(dx).any()
    parts_j, grad_j, _ = reference_parts("stereo")
    bad_j = dict(parts_j)
    bad_j[block] = parts_j[block].at[2].set(-jnp.eye(parts[block].shape[-1], dtype=F64))
    jstep = {"dense": jschur.schur_solve_dense, "pcg": jschur.schur_solve_pcg}[mode]
    assert np.isnan(np.asarray(jstep(bad_j, grad_j, jnp.asarray(1e-4, F64), jlm.Options(method="lm")))).any()

    calls = []

    def first_step_fails(p, g, lam, opt):
        calls.append(1)
        return solve_step(bad if len(calls) == 1 else p, g, lam, opt)

    plan = parts["plan"]
    solved, info = tlm.solve(tg, opt, assemble_fn=lambda g: tschur.ba_assemble(g, plan=plan),
                             solve_fn=first_step_fails)
    assert info.accepted.tolist()[:2] == [False, True]
    assert torch.isnan(info.update_norms[0]) and torch.isfinite(info.update_norms[1])
    assert info.lambda_history[1].item() == pytest.approx(1e-3)  # raised once by the rejection
    assert torch.isfinite(solved.blocks["poses"].values).all()
    assert info.chi2.item() < 0.01 * info.cost_history[0].item()


# --------------------------------------------------------------------------
# The masked PCG loop
# --------------------------------------------------------------------------


def _spd_system(n=40, seed=8):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    A = A @ A.T + 0.05 * n * np.eye(n)
    return A, rng.normal(size=n), 1.0 / np.diag(A)


@functools.cache
def _reference_pcg_iterations(rtol, max_iters):
    A, b, dinv = map(jnp.asarray, _spd_system())
    return int(jlin.pcg_solve(lambda v: A @ v, b, precond=lambda r: dinv * r, rtol=rtol, max_iters=max_iters)[1])


@pytest.mark.parametrize("read_every", [0, 1, 3, 5, 100])
@pytest.mark.parametrize("rtol,max_iters", [(1e-6, 200), (1e-3, 200), (1e-12, 7), (1e-6, 0)])
def test_pcg_solve_masked_is_pcg_solve(rtol, max_iters, read_every):
    A, b, dinv = _spd_system()
    At, bt, dt = torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(dinv)
    x_ref, it_ref = tlin.pcg_solve(lambda v: At @ v, bt, precond=lambda r: dt * r, rtol=rtol, max_iters=max_iters)
    if read_every == 0 and max_iters > 50:
        max_iters = 50  # never reading runs every iteration: keep it short
        x_ref, it_ref = tlin.pcg_solve(lambda v: At @ v, bt, precond=lambda r: dt * r, rtol=rtol, max_iters=50)
    reset_host_reads()
    x, it = profile_port.pcg_solve_masked(lambda v: At @ v, bt, lambda r: dt * r, rtol=rtol, max_iters=max_iters,
                                  read_every=read_every)
    assert it.dtype == torch.int32 and it.item() == it_ref
    assert_rel(x, x_ref.numpy(), 1e-12)
    if read_every == 0:
        assert HOST_READS["pcg"] == 0
    else:
        assert HOST_READS["pcg"] <= -(-it_ref // read_every) + 1
    assert it.item() == _reference_pcg_iterations(rtol, max_iters)


def test_pcg_solve_masked_stops_on_nan():
    """A NaN fails the stop test, as in ``pcg_solve``: x stays as it was."""
    A, b, dinv = _spd_system()
    At, bt, dt = torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(dinv)
    calls = []

    def matvec(v):
        calls.append(1)
        return At @ v * (float("nan") if len(calls) == 4 else 1.0)

    x, it = profile_port.pcg_solve_masked(matvec, bt, lambda r: dt * r, rtol=1e-12, max_iters=20, read_every=4)
    calls.clear()
    x_ref, it_ref = tlin.pcg_solve(matvec, bt, precond=lambda r: dt * r, rtol=1e-12, max_iters=20)
    assert it.item() == it_ref == 3
    np.testing.assert_array_equal(torch.isnan(x).numpy(), torch.isnan(x_ref).numpy())


# --------------------------------------------------------------------------
# Whole solves
# --------------------------------------------------------------------------

SOLVES = [
    ("stereo", "lm", 30, {}),
    ("stereo", "gn", 30, {}),
    ("slam", "lm", 25, dict(pcg_rtol=1e-12, pcg_max_iters=400)),
    ("bal", "lm", 30, {}),
    ("bal9", "lm", 30, {}),
    ("lm2d_bearing_range", "lm", 25, {}),
    ("lm2d_xy", "lm", 25, {}),
    ("lm2d_xy", "gn", 25, {}),
    ("every_branch", "lm", 25, {}),
]


@pytest.mark.parametrize("mode", ["dense", "pcg"])
@pytest.mark.parametrize("name,method,max_iters,extra", SOLVES)
def test_solve_schur_matches_reference(name, method, max_iters, extra, mode):
    jg, tg = graphs(name)
    kw = dict(method=method, max_iters=max_iters)
    js, ji = jschur.solve_schur(jg, jlm.Options(**kw), mode=mode, **extra)
    reset_host_reads()
    ts, ti = tschur.solve_schur(tg, tlm.Options(**kw), mode=mode, **extra)
    assert HOST_READS["lm"] == ti.iterations
    assert (HOST_READS["pcg"] > 0) == (mode == "pcg")
    assert ti.iterations == int(ji.iterations) and ti.status == int(ji.status)
    np.testing.assert_array_equal(ti.accepted.numpy(), np.asarray(ji.accepted))
    np.testing.assert_allclose(ti.chi2.item(), float(ji.chi2), rtol=1e-9)
    cost_t, cost_j = ti.cost_history.numpy(), np.asarray(ji.cost_history)
    np.testing.assert_array_equal(np.isnan(cost_t), np.isnan(cost_j))
    np.testing.assert_allclose(cost_t, cost_j, rtol=1e-8)
    for n in jg.blocks:
        np.testing.assert_allclose(ts.blocks[n].values.numpy(), np.asarray(js.blocks[n].values), rtol=0, atol=1e-6)
    # frozen elements did not move
    for n, b in tg.blocks.items():
        assert torch.equal(ts.blocks[n].values[b.const_mask], b.values[b.const_mask])


def test_solve_schur_reaches_the_ground_truth_cost():
    data = jsynth.ba_synthetic(n_cams=8, n_pts=60, seed=3)
    chi2_gt = float(jbuild.ba_graph(data, dtype=F64, init="gt").chi2())
    _, tg = graphs("stereo")
    for mode in ("dense", "pcg"):
        _, info = tschur.solve_schur(tg, tlm.Options(method="lm", max_iters=30), mode=mode)
        assert info.chi2.item() <= chi2_gt * 1.05
    _, mono = tlm.solve(tg, tlm.Options(method="lm", max_iters=30))
    np.testing.assert_allclose(info.chi2.item(), mono.chi2.item(), rtol=1e-6)


def test_solve_schur_in_f32():
    """The dtype of the graph is the dtype of every part and of the result."""
    jg, _ = graphs("stereo")
    tg = to_port(jg, dtype=torch.float32)
    parts, g, chi2 = tschur.ba_assemble(tg)
    assert {parts[k].dtype for k in ("Hpp", "Hll", "W", "PP", "g_p", "g_l")} == {torch.float32}
    assert g.dtype == chi2.dtype == torch.float32
    _, tg64 = graphs("stereo")
    _, ref = tschur.solve_schur(tg64, tlm.Options(method="lm", max_iters=30))
    for mode in ("dense", "pcg"):
        solved, info = tschur.solve_schur(tg, tlm.Options(method="lm", max_iters=30), mode=mode)
        assert solved.blocks["poses"].values.dtype == torch.float32
        np.testing.assert_allclose(info.chi2.item(), ref.chi2.item(), rtol=1e-3)
