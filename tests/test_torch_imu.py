"""IMU preintegration and visual-inertial graphs of the torch port
(``pyslam_tpu_torch/imu.py``) against the JAX reference, in f64 on the CPU,
on ``synth.imu_circle`` trajectories of 2 to 4 keyframes.

Tolerances: ``preintegrate`` and ``sqrt_info_of`` 1e-12 (relative to each
field's largest entry); the ``imu_preintegrated`` and
``between_euclidean`` residuals and Jacobians 1e-10; ``vio_graph``'s
arrays 1e-12 relative; LM solves the same iteration counts and stop codes,
chi2 1e-8 relative.  The batched recursion of ``vio_graph`` gives an
interval padded with dt = 0 samples, and an interval inside a batch of
others, the bits of that interval alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu import imu as J
from pyslam_tpu.graph.core import FACTOR_KERNELS as JK
from pyslam_tpu.io import euroc as jeuroc
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.lie import se3 as jse3
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu_torch import imu as T
from pyslam_tpu_torch.graph.core import FACTOR_KERNELS as TK
from pyslam_tpu_torch.solver import lm as tlm
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

B_G = np.array([0.002, -0.001, 0.003])
B_A = np.array([0.05, -0.03, 0.02])


def _noisy(n_keyframes, seed=0, **kw):
    return jsynth.imu_circle(n_keyframes=n_keyframes, kf_dt=0.5, imu_rate=200, gyro_noise=1.7e-4 * np.sqrt(200),
                             accel_noise=2e-3 * np.sqrt(200), b_gyro=B_G, b_accel=B_A, seed=seed, **kw)


def _close(out, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


def test_preintegrate_and_sqrt_info_match_reference():
    d = _noisy(3)
    for i in range(2):
        args = (d.omega[i], d.accel[i], d.dts[i], B_G * 0.5, B_A * (i - 0.5))
        ref = J.preintegrate(*args)
        out = T.preintegrate(*args, device="cpu")
        assert out._fields == ref._fields
        for name in ref._fields:
            assert getattr(out, name).dtype == torch.float64
            _close(getattr(out, name).numpy(), getattr(ref, name), 1e-12)
        _close(T.sqrt_info_of(out), J.sqrt_info_of(ref), 1e-12)
    # tensors in: their dtype and device
    t = T.preintegrate(*(torch.from_numpy(np.asarray(a, np.float32)) for a in args))
    assert t.dR.dtype == torch.float32 and t.cov.device.type == "cpu"


def test_padded_and_batched_intervals_give_the_same_bits():
    d = _noisy(4, seed=2)
    f64 = dict(dtype=torch.float64)
    w, a, dt = (torch.from_numpy(np.asarray(x)) for x in (d.omega, d.accel, d.dts))
    b = torch.zeros((3, 3), **f64)
    alone = [T._preintegrate_batched(w[i:i + 1], a[i:i + 1], dt[i:i + 1], b[:1], b[:1], 1.7e-4, 2e-3)
             for i in range(3)]
    # interval 1 cut short by 13 samples, every interval padded to K + 5
    K = dt.shape[1]
    cut = [K, K - 13, K]
    pw, pa, pdt = torch.zeros((3, K + 5, 3), **f64), torch.zeros((3, K + 5, 3), **f64), torch.zeros((3, K + 5), **f64)
    for i, k in enumerate(cut):
        pw[i, :k], pa[i, :k], pdt[i, :k] = w[i, :k], a[i, :k], dt[i, :k]
    batched = T._preintegrate_batched(pw, pa, pdt, b, b, 1.7e-4, 2e-3)
    short = T._preintegrate_batched(w[1:2, :K - 13], a[1:2, :K - 13], dt[1:2, :K - 13], b[:1], b[:1], 1.7e-4, 2e-3)
    for name in batched._fields:
        for i in range(3):
            one = (short if i == 1 else alone[i])
            assert torch.equal(getattr(batched, name)[i], getattr(one, name)[0]), (name, i)


@pytest.fixture
def factor_inputs():
    """One preintegrated factor of imu_circle(3) and perturbed states, in
    numpy."""
    rng = np.random.default_rng(5)
    d = _noisy(3)
    pim = J.preintegrate(d.omega[0], d.accel[0], d.dts[0], np.zeros(3), np.zeros(3))
    data = {k: np.asarray(getattr(pim, k))[None] for k in T._PIM_DATA}
    data["sqrt_info"] = np.asarray(J.sqrt_info_of(pim))[None]
    data["gravity"] = np.asarray(d.gravity)[None]
    T_i = np.asarray(jse3.exp(jnp.asarray(rng.normal(size=6) * 0.1)))[None] @ d.T_gt[0][None]
    T_j = np.asarray(jse3.exp(jnp.asarray(rng.normal(size=6) * 0.1)))[None] @ d.T_gt[1][None]
    args = [T_i, T_j, (d.v_gt[0] + rng.normal(size=3) * 0.2)[None], (d.v_gt[1] + rng.normal(size=3) * 0.2)[None],
            rng.normal(size=(1, 6)) * 0.05]
    return data, args


def test_imu_factor_matches_reference(factor_inputs):
    data, args = factor_inputs
    rj, jj = JK["imu_preintegrated"]({k: jnp.asarray(v) for k, v in data.items()}, *(jnp.asarray(x) for x in args))
    rt, jt = TK["imu_preintegrated"]({k: torch.tensor(v) for k, v in data.items()}, *(torch.tensor(x) for x in args))
    _close(rt.numpy(), rj, 1e-10)
    assert [J_.shape for J_ in jt] == [(1, 9, 6), (1, 9, 6), (1, 9, 3), (1, 9, 3), (1, 9, 6)]
    for a, b in zip(jt, jj):
        _close(a.numpy(), b, 1e-10)


def test_between_euclidean_matches_reference():
    rng = np.random.default_rng(1)
    data = {"delta": rng.normal(size=(3, 6)), "sqrt_info": np.stack([np.diag(rng.uniform(0.5, 2, 6))] * 3)}
    x_i, x_j = rng.normal(size=(3, 6)), rng.normal(size=(3, 6))
    rj, jj = JK["between_euclidean"]({k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(x_i), jnp.asarray(x_j))
    rt, jt = TK["between_euclidean"]({k: torch.tensor(v) for k, v in data.items()}, torch.tensor(x_i),
                                     torch.tensor(x_j))
    _close(rt.numpy(), rj, 1e-10)
    for a, b in zip(jt, jj):
        _close(a.numpy(), b, 1e-10)


def _vio_inputs(n, seed=1, **kw):
    d = _noisy(n, **kw)
    rng = np.random.default_rng(seed)
    T_prior = np.stack([np.asarray(jse3.exp(jnp.asarray(rng.normal(size=6) * 2e-3))) @ d.T_gt[i] for i in range(n)])
    return d, T_prior, np.diag([1 / 2e-3] * 6), dict(T_init=T_prior, v_init=np.zeros((n, 3)), b_init=np.zeros((n, 6)))


def _same_vio_graph(tg, jg):
    assert list(tg.blocks) == list(jg.blocks)
    for name, b in tg.blocks.items():
        assert b.kind == jg.blocks[name].kind
        _close(b.values.numpy(), jg.blocks[name].values, 1e-12)
    for fb, jfb in zip(tg.batches, jg.batches):
        assert (fb.kind, tuple(fb.slots)) == (jfb.kind, tuple(jfb.slots))
        for i, ji in zip(fb.indices, jfb.indices):
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert fb.data.keys() == jfb.data.keys()
        for k in fb.data:
            _close(fb.data[k].numpy(), jfb.data[k], 1e-12)


def _sparse_prior_inputs():
    """imu_circle(3) with pose priors on the first and the last keyframe
    only (``prior_indices``); the middle pose starts perturbed, the
    velocities at zero."""
    d, T_prior, S, _ = _vio_inputs(3, seed=7)
    return (d, T_prior[[0, 2]], S), dict(T_init=T_prior, v_init=np.zeros((3, 3)), prior_indices=[0, 2])


@pytest.fixture(scope="module")
def reference_vio():
    """The reference's graph and LM solve of imu_circle(4) with pose priors
    on every keyframe, and of imu_circle(3) with two."""
    out = {}
    d, T_prior, S, kw = _vio_inputs(4)
    g = J.vio_graph(d, T_prior, S, **kw)
    out["priors"] = (g, jlm.solve(g, jlm.Options(method="lm", max_iters=60)))
    args, kw = _sparse_prior_inputs()
    g3 = J.vio_graph(*args, **kw)
    out["sparse_priors"] = (g3, jlm.solve(g3, jlm.Options(method="lm", max_iters=40)))
    return out


@pytest.mark.parametrize("case", ["priors", "sparse_priors"])
def test_vio_graph_and_solve_match_reference(case, reference_vio):
    if case == "priors":
        d, T_prior, S, kw = _vio_inputs(4)
        tg = T.vio_graph(d, T_prior, S, device="cpu", **kw)
        max_iters = 60
    else:
        args, kw = _sparse_prior_inputs()
        tg = T.vio_graph(*args, device="cpu", **kw)
        max_iters = 40
    jg, (js, ji) = reference_vio[case]
    _same_vio_graph(tg, jg)
    assert all(b.values.dtype == torch.float64 for b in tg.blocks.values())
    solved, info = tlm.solve(tg, tlm.Options(method="lm", max_iters=max_iters))
    assert (info.iterations, info.status) == (int(ji.iterations), int(ji.status))
    np.testing.assert_allclose(info.chi2.item(), float(ji.chi2), rtol=1e-8)
    for name in ("poses", "vels", "biases"):
        np.testing.assert_allclose(solved.blocks[name].values.numpy(), np.asarray(js.blocks[name].values), rtol=0,
                                   atol=1e-6)


def test_vio_graph_from_euroc_segments_of_unequal_length():
    """Keyframe times between IMU samples (``segment_imu``'s zero-order
    hold): the port takes the ragged intervals and equals the reference
    given them padded with dt = 0 samples."""
    d, T_prior, S, kw = _vio_inputs(3, seed=4)
    n_int, K = d.dts.shape
    t = np.arange(n_int * K) * d.dts[0, 0]
    t_kf = np.array([0.0, 0.5012, 0.9987])
    segs = jeuroc.segment_imu(t, d.omega.reshape(-1, 3), d.accel.reshape(-1, 3), t_kf)
    lengths = [len(s[2]) for s in segs]
    assert len(set(lengths)) > 1
    ragged = jsynth.ImuData(d.T_gt, d.v_gt, d.b_gyro, d.b_accel, [s[0] for s in segs], [s[1] for s in segs],
                            [s[2] for s in segs], d.gravity)
    pad = [np.zeros((2, max(lengths), 3)), np.zeros((2, max(lengths), 3)), np.zeros((2, max(lengths)))]
    for i, s in enumerate(segs):
        for p, x in zip(pad, s):
            p[i, : len(x)] = x
    padded = jsynth.ImuData(d.T_gt, d.v_gt, d.b_gyro, d.b_accel, *pad, d.gravity)
    tg = T.vio_graph(ragged, T_prior, S, device="cpu", **kw)
    jg = J.vio_graph(padded, T_prior, S, **kw)
    _same_vio_graph(tg, jg)
    np.testing.assert_allclose(tg.chi2().item(), float(jg.chi2()), rtol=1e-10)
