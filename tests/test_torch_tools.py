"""The tools of the torch port against the JAX reference, in f64 on the CPU:
the Lie group wrappers (``lie/groups.py``: every method within 1e-12 of
the reference's on the same numpy inputs), ``utils.py`` (1e-12; the
packed sampler the same bits as the four-gather one), ``debug.py`` (the
reference's messages; ``nan_debug`` raises at the first NaN and restores
its state) and ``observability.py`` (iteration records within 1e-8 of the
reference's for the same solve, checkpoints in the reference's npz
layout, the profiler's trace file with the solver's spans).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyslam_tpu.lie as JL
import pyslam_tpu_torch.lie as TL
from pyslam_tpu import debug as jdebug
from pyslam_tpu import observability as jobs
from pyslam_tpu import utils as jutils
from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import Options as JOptions
from pyslam_tpu.solver import solve as jsolve
from pyslam_tpu_torch import debug, observability as obs, utils
from pyslam_tpu_torch.graph import build
from pyslam_tpu_torch.graph.core import FactorBatch, FactorGraph
from pyslam_tpu_torch.io import synth
from pyslam_tpu_torch.solver import Options, solve
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

TOL = 1e-12


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    out = out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1.0))


# --------------------------------------------------------------------------
# Lie group wrappers
# --------------------------------------------------------------------------

GROUPS = {"SO2": 1, "SO3": 3, "SE2": 3, "SE3": 6, "Sim3": 7}


def _tangent(name, rng, batch=(4,)):
    dof = GROUPS[name]
    return rng.normal(size=batch if dof == 1 else batch + (dof,)) * 0.7


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_group_methods_match_reference(name):
    rng = np.random.default_rng(sorted(GROUPS).index(name))
    J, T = getattr(JL, name), getattr(TL, name)
    xi, xi2, dxi = _tangent(name, rng), _tangent(name, rng), _tangent(name, rng)
    ja, ta = J.exp(jnp.asarray(xi)), T.exp(torch.tensor(xi))
    jb, tb = J.exp(jnp.asarray(xi2)), T.exp(torch.tensor(xi2))
    _close(ta.mat, ja.mat)
    _close(ta.log(), ja.log())
    _close(ta.inv().mat, ja.inv().mat)
    _close(ta.dot(tb).mat, ja.dot(jb).mat)
    _close((ta * tb).mat, (ja * jb).mat)
    _close(ta.perturb(torch.tensor(dxi)).mat, ja.perturb(jnp.asarray(dxi)).mat)
    _close(T.wedge(torch.tensor(xi)), J.wedge(jnp.asarray(xi)))
    _close(T.vee(T.wedge(torch.tensor(xi))), J.vee(J.wedge(jnp.asarray(xi))))
    _close(ta.normalize().mat, ja.normalize().mat)
    _close(T.from_matrix(ta.mat, normalize=True).mat, J.from_matrix(ja.mat, normalize=True).mat)
    assert ta.as_matrix() is ta.mat and type(ta.inv()) is T
    if name != "SO2":
        _close(T.left_jacobian(torch.tensor(xi)), J.left_jacobian(jnp.asarray(xi)))
        _close(T.inv_left_jacobian(torch.tensor(xi)), J.inv_left_jacobian(jnp.asarray(xi)))
    d = T.dim - (0 if name.startswith("SO") else 1)
    pts = rng.normal(size=(4, d))
    _close(ta.dot(torch.tensor(pts)), ja.dot(jnp.asarray(pts)))
    if name in ("SE2", "SE3", "Sim3"):
        _close(ta.adjoint(), ja.adjoint())
        _close(ta.rot.mat, ja.rot.mat)
        _close(ta.trans, ja.trans)
    if name in ("SE2", "SE3"):
        _close(T.odot(torch.tensor(pts)), J.odot(jnp.asarray(pts)))
    if name == "Sim3":
        _close(ta.scale, ja.scale)


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_group_identity_and_small_angles(name):
    J, T = getattr(JL, name), getattr(TL, name)
    ident = T.identity(batch_shape=(2,), dtype=torch.float64, device="cpu")
    _close(ident.mat, J.identity(batch_shape=(2,), dtype=jnp.float64).mat)
    assert ident.mat.device.type == "cpu" and ident.mat.dtype == torch.float64
    tiny = np.full((2,) if GROUPS[name] == 1 else (2, GROUPS[name]), 1e-9)
    _close(T.exp(torch.tensor(tiny)).log(), J.exp(jnp.asarray(tiny)).log())


# --------------------------------------------------------------------------
# utils
# --------------------------------------------------------------------------


def test_invsqrt_and_stackmul_match_reference():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(7, 4, 4))
    S = A @ np.swapaxes(A, -1, -2) + 3 * np.eye(4)
    _close(utils.invsqrt(torch.tensor(S)), jutils.invsqrt(jnp.asarray(S)), 1e-10)
    W = utils.invsqrt(torch.tensor(S[0])).numpy()
    np.testing.assert_allclose(W @ S[0] @ W.T, np.eye(4), atol=1e-9)
    assert float(utils.invsqrt(torch.tensor(4.0, dtype=torch.float64))) == 0.5
    B = rng.normal(size=(7, 4, 2))
    _close(utils.stackmul(torch.tensor(A), torch.tensor(B)), A @ B)


@pytest.mark.parametrize("channels", [None, 3])
def test_bilinear_interpolate_matches_reference(channels):
    rng = np.random.default_rng(1)
    im = rng.normal(size=(9, 11) if channels is None else (9, 11, channels))
    u, v = rng.uniform(-1, 12, 40), rng.uniform(-1, 10, 40)
    out = utils.bilinear_interpolate(torch.tensor(im), torch.tensor(u), torch.tensor(v), compute_gradients=True)
    ref = jutils.bilinear_interpolate(jnp.asarray(im), jnp.asarray(u), jnp.asarray(v), compute_gradients=True)
    for a, b in zip(out, ref):
        _close(a, b)
    if channels is None:
        im4 = utils.pack_corners(torch.tensor(im))
        _close(im4, jutils.pack_corners(jnp.asarray(im)))
        packed = utils.bilinear_interpolate_packed(im4, 9, 11, torch.tensor(u), torch.tensor(v), compute_gradients=True)
        for a, b in zip(packed, out):
            assert torch.equal(a, b)


def test_bilinear_gradients_match_autograd():
    im = torch.tensor(np.random.default_rng(2).normal(size=(9, 9)))
    uv = torch.tensor([3.3, 4.7], dtype=torch.float64, requires_grad=True)
    _, gu, gv = utils.bilinear_interpolate(im, uv[0].detach(), uv[1].detach(), compute_gradients=True)
    (g,) = torch.autograd.grad(utils.bilinear_interpolate(im, uv[0], uv[1]), uv)
    _close(torch.stack([gu, gv]), g)


def test_kahan_sum_matches_reference():
    rng = np.random.default_rng(0)
    x64 = rng.uniform(0.1, 1.0, 200_000)
    ks = float(utils.kahan_sum(torch.tensor(x64, dtype=torch.float32)))
    assert ks == float(jutils.kahan_sum(jnp.asarray(x64, jnp.float32)))
    assert abs(ks - np.sum(x64)) / np.sum(x64) < 1e-6
    assert float(utils.kahan_sum(torch.zeros(0))) == 0.0


# --------------------------------------------------------------------------
# debug
# --------------------------------------------------------------------------


def _loops():
    data = jsynth.se2_loop(n_poses=10, n_loops=2, seed=0)
    return jbuild.pose_graph(data, dtype=jnp.float64), build.pose_graph(
        synth.se2_loop(n_poses=10, n_loops=2, seed=0), dtype=torch.float64, device="cpu")


def _faults():
    """(name, jax graph, torch graph) of the reference's lint cases."""
    jg, tg = _loops()
    jf, tf = jg.batches[0], tg.batches[0]
    out = [("clean", jg, tg)]
    ti = tf.indices[0].clone()
    ti[0] = 999
    out.append(("index", type(jg)(jg.blocks, [type(jf)(jf.kind, jf.slots, (jf.indices[0].at[0].set(999), jf.indices[1]),
                                                       jf.data, jf.loss, jf.weight)]),
                FactorGraph(tg.blocks, [FactorBatch(tf.kind, tf.slots, (ti, tf.indices[1]), tf.data, tf.loss,
                                                    tf.weight)])))
    tT = tf.data["T_obs"].clone()
    tT[0, 0, 0] = float("nan")
    out.append(("nonfinite",
                type(jg)(jg.blocks, [type(jf)(jf.kind, jf.slots, jf.indices,
                                              {**jf.data, "T_obs": jf.data["T_obs"].at[0, 0, 0].set(jnp.nan)},
                                              jf.loss, jf.weight)]),
                FactorGraph(tg.blocks, [FactorBatch(tf.kind, tf.slots, tf.indices, {**tf.data, "T_obs": tT}, tf.loss,
                                                    tf.weight)])))
    tw = tf.weight.clone()
    tw[0] = -1.0
    out.append(("weight", type(jg)(jg.blocks, [type(jf)(jf.kind, jf.slots, jf.indices, jf.data, jf.loss,
                                                        jf.weight.at[0].set(-1.0))]),
                FactorGraph(tg.blocks, [FactorBatch(tf.kind, tf.slots, tf.indices, tf.data, tf.loss, tw)])))
    return out


def test_validate_graph_gives_the_reference_messages():
    for name, jg, tg in _faults():
        problems = debug.validate_graph(tg)
        assert problems == jdebug.validate_graph(jg), name
        assert (problems == []) == (name == "clean")
        if problems:
            with pytest.raises(ValueError, match="invalid FactorGraph"):
                debug.assert_graph_valid(tg)
    debug.assert_graph_valid(_faults()[0][2])


def test_nan_debug_raises_at_the_first_nan_and_restores():
    x = torch.tensor([1.0, -1.0], dtype=torch.float64)
    assert torch.isnan(torch.sqrt(x)).any()  # no check outside the block
    with debug.nan_debug():
        torch.sqrt(torch.abs(x))
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(x)
        with debug.nan_debug(False):
            assert torch.isnan(torch.sqrt(x)).any()
        with pytest.raises(FloatingPointError):
            torch.log(x)
    assert torch.isnan(torch.log(x)).any()
    assert debug._CHECKING == [False]


# --------------------------------------------------------------------------
# observability
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def solves():
    """One LM solve of se2_loop(30) in each package."""
    data = synth.se2_loop(n_poses=30, seed=0)
    g = build.pose_graph(data, dtype=torch.float64, device="cpu")
    solved, info = solve(g, Options(method="lm", max_iters=15))
    _, jinfo = jsolve(jbuild.pose_graph(jsynth.se2_loop(n_poses=30, seed=0), dtype=jnp.float64),
                      JOptions(method="lm", max_iters=15))
    return g, solved, info, jinfo


def test_iteration_log_matches_reference(solves, tmp_path):
    _, _, info, jinfo = solves
    recs, jrecs = obs.iteration_records(info), jobs.iteration_records(jinfo)
    assert len(recs) == len(jrecs) == int(info.iterations) >= 1
    for r, jr in zip(recs, jrecs):
        assert r.keys() == jr.keys() and r["accepted"] == jr["accepted"] and r["iter"] == jr["iter"]
        for k in ("cost_before", "cost_after", "lambda", "update_norm"):
            assert abs(r[k] - jr[k]) <= 1e-8 * max(abs(jr[k]), 1e-12), k
    path = str(tmp_path / "solve.jsonl")
    obs.write_iteration_log(info, path, extra={"config": "se2_loop"})
    lines = [json.loads(line) for line in open(path)]
    assert lines[-1]["summary"] is True and lines[-1]["iterations"] == int(info.iterations)
    assert lines[0]["config"] == "se2_loop" and len(lines) == len(recs) + 1


def test_state_roundtrip(tmp_path):
    state = {"a": torch.arange(5.0, dtype=torch.float64), "b": (torch.eye(3), np.zeros(2), 1.5), "c": [np.int64(3)]}
    p = str(tmp_path / "state.npz")
    obs.save_state(p, state)
    back = obs.load_state(p, state)
    assert torch.equal(back["a"], state["a"]) and back["a"].dtype == torch.float64
    assert torch.equal(back["b"][0], torch.eye(3)) and isinstance(back["b"][1], np.ndarray) and back["b"][2] == 1.5


def test_checkpoint_keeps_the_reference_layout(tmp_path):
    """A whole FactorGraph saved by each package: the same leaves in the
    same order (indices int64 here, int32 there)."""
    jg, tg = _loops()
    obs.save_state(str(tmp_path / "t.npz"), tg)
    jobs.save_state(str(tmp_path / "j.npz"), jg)
    t, j = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    leaves = sorted(k for k in j.files if k.startswith("leaf_"))
    assert sorted(k for k in t.files if k.startswith("leaf_")) == leaves
    for k in leaves:
        np.testing.assert_array_equal(t[k], j[k])
    back = obs.load_state(str(tmp_path / "t.npz"), tg)
    assert float(back.chi2()) == float(tg.chi2())


def test_graph_checkpoint_resume_exact(solves, tmp_path):
    g, solved, info, _ = solves
    ckpt = obs.graph_checkpoint(solved)
    p = str(tmp_path / "g.npz")
    obs.save_state(p, ckpt)
    restored = obs.graph_restore(g, obs.load_state(p, ckpt))
    assert float(restored.chi2()) == float(solved.chi2())
    _, info2 = solve(restored, Options(method="lm", max_iters=5))
    assert float(info2.chi2) <= float(info.chi2) * (1 + 1e-9)


def test_profile_trace_and_timed(tmp_path):
    """A solve under ``profile_trace`` writes the solver's timed spans into
    ``trace.json`` beside the ops they ran, as many ranges of each name as
    the span totals count."""
    g = build.pose_graph(synth.se2_loop(n_poses=12, seed=0), dtype=torch.float64, device="cpu")
    obs.reset_spans()
    with obs.profile_trace(str(tmp_path / "trace")):
        solve(g, Options(method="lm", max_iters=3))
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert any("mm" in n for n in names)
    assert {"solve", "lm.iteration", "lm.retract", "read"} <= set(obs.SPAN_CALLS)
    for name, calls in obs.SPAN_CALLS.items():
        assert names.count(name) == calls and obs.SPAN_NS[name] > 0
