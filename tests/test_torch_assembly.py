"""Graph building, direct-to-ELL assembly and the block-Jacobi inverse of
the torch port against the JAX reference, in f64 on the CPU, on the same
problem: ``se3_sphere(n_poses=60, seed=11)``, carried across with
``graph_from_numpy``.  Tolerance: 1e-10 relative to the largest entry."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorBatch as JFactorBatch
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.losses import CauchyLoss as JCauchy
from pyslam_tpu.losses import L2Loss as JL2
from pyslam_tpu.solver import bcsr as jb
from pyslam_tpu_torch.graph import FACTOR_KERNELS, MANIFOLDS, FactorGraph, graph_from_numpy, manifold_dof
from pyslam_tpu_torch.graph import build as tbuild
from pyslam_tpu_torch.io import synth as tsynth
from pyslam_tpu_torch.losses import CauchyLoss as TCauchy
from pyslam_tpu_torch.solver import bcsr as tb
from pyslam_tpu_torch.solver.assemble import free_mask, linearize_batch
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

REL = 1e-10


def jax_graph(name):
    """The reference problems of the parity tests.  'l2': the plain pose
    graph.  'robust_prior': Cauchy loss, plus a second batch of SE(3)
    priors on a few poses, one of them padding (weight 0)."""
    data = jsynth.se3_sphere(n_poses=60, seed=11)
    if name == "l2":
        return jbuild.pose_graph(data, dtype=jnp.float64)
    g = jbuild.pose_graph(data, loss=JCauchy(k=2.0), dtype=jnp.float64)
    idx = np.array([5, 17, 30, 44], np.int32)
    prior = JFactorBatch.create(
        kind="prior_se3",
        slots=("poses",),
        indices=(idx,),
        data={
            "T_obs": jnp.asarray(data.T_gt[idx]),
            "sqrt_info": jnp.asarray(np.broadcast_to(np.eye(6) * 10.0, (4, 6, 6))),
        },
        loss=JL2(),
        weight=jnp.asarray([1.0, 1.0, 0.0, 1.0]),
    )
    return JFactorGraph(g.blocks, [*g.batches, prior])


def _datum(v):
    """A ``data`` value as ``graph_from_numpy`` takes it: an array, or a
    camera as (class name, fields)."""
    if dataclasses.is_dataclass(v):
        fields = dataclasses.asdict(v)
        return type(v).__name__, {k: np.asarray(f).item() if np.ndim(f) == 0 else f for k, f in fields.items()}
    return np.asarray(v)


def to_port(g, dtype=torch.float64, device="cpu"):
    """The port's graph of a reference graph, through numpy arrays."""
    blocks = {
        n: dict(kind=b.kind, values=np.asarray(b.values), const_mask=np.asarray(b.const_mask))
        for n, b in g.blocks.items()
    }
    batches = [
        dict(
            kind=fb.kind,
            slots=fb.slots,
            indices=[np.asarray(i) for i in fb.indices],
            data={k: _datum(v) for k, v in fb.data.items()},
            weight=np.asarray(fb.weight),
            loss=(type(fb.loss).__name__, dataclasses.asdict(fb.loss)),
        )
        for fb in g.batches
    ]
    return graph_from_numpy(blocks, batches, dtype=dtype, device=device)


def assert_rel(out, ref, rel=REL):
    ref = np.asarray(ref)
    out = out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


GRAPHS = ["l2", "robust_prior"]


def test_pose_graph_matches_reference():
    jg = jbuild.pose_graph(jsynth.se3_sphere(n_poses=60, seed=11), dtype=jnp.float64)
    tg = tbuild.pose_graph(tsynth.se3_sphere(n_poses=60, seed=11), dtype=torch.float64, device="cpu")
    jb_, tb_ = jg.blocks["poses"], tg.blocks["poses"]
    np.testing.assert_array_equal(tb_.values.numpy(), np.asarray(jb_.values))
    np.testing.assert_array_equal(tb_.const_mask.numpy(), np.asarray(jb_.const_mask))
    (jf,), (tf,) = jg.batches, tg.batches
    assert (tf.kind, tf.slots) == (jf.kind, jf.slots)
    for a, b in zip(tf.indices, jf.indices):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in jf.data:
        np.testing.assert_array_equal(tf.data[k].numpy(), np.asarray(jf.data[k]))
    assert tf.weight.dtype == torch.float64
    np.testing.assert_array_equal(tf.weight.numpy(), np.asarray(jf.weight))


@pytest.mark.parametrize("name", GRAPHS)
def test_chi2_matches_reference(name):
    jg = jax_graph(name)
    assert_rel(to_port(jg).chi2(), jg.chi2())


@pytest.mark.parametrize("name", GRAPHS)
def test_build_ell_direct_matches_reference(name):
    jg = jax_graph(name)
    jp, tp = jb.build_ell_direct(jg), tb.build_ell_direct(to_port(jg))
    assert (tp.nb, tp.d, tp.K) == (jp.nb, jp.d, jp.K)
    np.testing.assert_array_equal(tp.cols, jp.cols)
    np.testing.assert_array_equal(tp.valid, jp.valid)
    for tm, jm in zip(tp.maps, jp.maps):
        for (ta, tb_, tab, tba), (ja, jb_, jab, jba) in zip(tm, jm):
            assert (ta, tb_) == (ja, jb_)
            np.testing.assert_array_equal(tab, jab)
            assert (tba is None) == (jba is None)
            if tba is not None:
                np.testing.assert_array_equal(tba, jba)


@pytest.mark.parametrize("name", GRAPHS)
def test_assemble_ell_matches_reference(name):
    jg = jax_graph(name)
    He_j, g_j, c_j = jb.assemble_ell(jg, jb.build_ell_direct(jg))
    tg = to_port(jg)
    He_t, g_t, c_t = tb.assemble_ell(tg, tb.ell_device_plan(tb.build_ell_direct(tg), "cpu"))
    assert_rel(He_t, He_j)
    assert_rel(g_t, g_j)
    assert_rel(c_t, c_j)


@pytest.mark.parametrize("name", GRAPHS)
def test_slot_plans_cover_every_contribution(name):
    tg = to_port(jax_graph(name))
    plan = tb.build_ell_direct(tg)
    hp, gp = tb.build_slot_plans(plan)
    h, g, _ = tb.ell_contributions(tg, plan)
    assert (hp.n_slots, gp.n_slots) == (plan.nb * plan.K, plan.nb)
    assert sorted(hp.perm.tolist()) == list(range(h.shape[0]))
    assert sorted(gp.perm.tolist()) == list(range(g.shape[0]))
    assert hp.offsets[-1] == h.shape[0] and gp.offsets[-1] == g.shape[0]


@pytest.mark.parametrize("d", [1, 2, 3, 4, 6, 9])
def test_sym_block_inv_matches_reference(d):
    rng = np.random.default_rng(d)
    A = rng.normal(size=(20, d, d))
    D = A @ A.transpose(0, 2, 1) + d * np.eye(d)
    assert_rel(tb.sym_block_inv(torch.from_numpy(D)), jb.sym_block_inv(jnp.asarray(D)))


def test_sym_block_inv_on_damped_diagonal_blocks():
    """The d=6 closed form on the slot-0 blocks the solver inverts."""
    jg = jax_graph("l2")
    He, _, _ = jb.assemble_ell(jg, jb.build_ell_direct(jg))
    D = np.asarray(He[:, 0])
    D = D + 1e-4 * np.einsum("ni,ij->nij", np.maximum(np.einsum("nii->ni", D), 1e-12), np.eye(6))
    assert_rel(tb.sym_block_inv(torch.from_numpy(D)), jb.sym_block_inv(jnp.asarray(D)))


def test_sym_block_inv_fallback_gives_nan_where_cholesky_fails():
    D = np.stack([np.eye(4) * 2.0, np.diag([1.0, -1.0, 1.0, 1.0])])
    out = tb.sym_block_inv(torch.from_numpy(D)).numpy()
    ref = np.asarray(jb.sym_block_inv(jnp.asarray(D)))
    np.testing.assert_allclose(out[0], np.eye(4) * 0.5, rtol=0, atol=1e-15)
    assert np.isnan(out[1]).all() and np.isnan(ref[1]).any()


def test_free_mask_freezes_anchor():
    tg = to_port(jax_graph("l2"))
    free = free_mask(tg)
    assert free.shape == (60 * 6,)
    assert not free[:6].any() and free[6:].all()


def test_out_of_range_index_raises():
    """JAX clamps an out-of-range index silently; the port refuses it at
    plan build."""
    tg = to_port(jax_graph("l2"))
    fb = tg.batches[0]
    bad = dataclasses.replace(fb, indices=(fb.indices[0], fb.indices[1].clone().fill_(60)))
    with pytest.raises(ValueError, match="out of range"):
        tb.build_ell_direct(FactorGraph(tg.blocks, [bad]))
    plan = tb.build_ell_direct(tg)
    broken = dataclasses.replace(plan, cols=np.full_like(plan.cols, 60))
    with pytest.raises(ValueError, match="cols"):
        tb.ell_device_plan(broken, "cpu")


def test_linearize_batch_rejects_wrong_jacobian_width(monkeypatch):
    tg = to_port(jax_graph("l2"))
    fb = tg.batches[0]

    def narrow(data, T1, T2, compute_jacobians=True):
        r, (J1, J2) = FACTOR_KERNELS["between_se3"](data, T1, T2, compute_jacobians)
        return r, (J1[..., :3], J2)

    monkeypatch.setitem(FACTOR_KERNELS, "narrow_se3", narrow)
    with pytest.raises(ValueError, match="Jacobian width 3"):
        linearize_batch(dataclasses.replace(fb, kind="narrow_se3"), tg.blocks)


@pytest.mark.parametrize("case", ["init_chordal", "init_spanning_tree"])
def test_unported_parts_raise(case):
    """The 'chordal' and 'spanning_tree' inits, the last parts of
    ``pose_graph`` to be ported: the reference's poses (1e-8) on SE(3)
    data, ValueError on Sim(3) data as in the reference."""
    init = case.split("_", 1)[1]
    tg = tbuild.pose_graph(tsynth.se3_sphere(n_poses=30, seed=0), init=init, dtype=torch.float64, device="cpu")
    jg = jbuild.pose_graph(jsynth.se3_sphere(n_poses=30, seed=0), init=init, dtype=jnp.float64)
    np.testing.assert_allclose(tg.blocks["poses"].values.numpy(), np.asarray(jg.blocks["poses"].values), rtol=0,
                               atol=1e-8)
    with pytest.raises(ValueError, match="Sim"):
        tbuild.pose_graph(tsynth.sim3_loop(n_poses=10, n_loops=1, seed=0), init=init, device="cpu")


@pytest.mark.parametrize("kind", ["se2", "sim3"])
def test_pose_graph_2d_and_sim3_match_reference(kind):
    """``pose_graph`` routes 2-D data to SE(2) and 7-dof 3-D data to
    ``sim3_pose_graph``, with the reference's arrays."""
    if kind == "se2":
        jd, td = jsynth.se2_loop(n_poses=20, n_loops=3, seed=2), tsynth.se2_loop(n_poses=20, n_loops=3, seed=2)
    else:
        jd, td = jsynth.sim3_loop(n_poses=20, n_loops=2, seed=2), tsynth.sim3_loop(n_poses=20, n_loops=2, seed=2)
    jg = jbuild.pose_graph(jd, loss=JCauchy(k=1.5), dtype=jnp.float64)
    tg = tbuild.pose_graph(td, loss=TCauchy(k=1.5), dtype=torch.float64, device="cpu")
    jb_, tb_ = jg.blocks["poses"], tg.blocks["poses"]
    assert tb_.kind == jb_.kind == kind and tb_.dof == jb_.dof
    np.testing.assert_array_equal(tb_.values.numpy(), np.asarray(jb_.values))
    np.testing.assert_array_equal(tb_.const_mask.numpy(), np.asarray(jb_.const_mask))
    (jf,), (tf,) = jg.batches, tg.batches
    assert (tf.kind, tf.slots) == (jf.kind, jf.slots) == (f"between_{kind}", ("poses", "poses"))
    for k in jf.data:
        np.testing.assert_array_equal(tf.data[k].numpy(), np.asarray(jf.data[k]))
    assert_rel(tg.chi2(), jg.chi2())


def test_manifold_table_matches_reference():
    """Every kind of the reference's table, with the same dof and element
    shape; 'euclidean' takes its dof from the element shape."""
    from pyslam_tpu.graph import core as jcore

    assert set(MANIFOLDS) == set(jcore.MANIFOLDS)
    for kind, entry in MANIFOLDS.items():
        assert (entry["dof"], entry["shape"]) == (jcore.MANIFOLDS[kind]["dof"], jcore.MANIFOLDS[kind]["shape"])
    assert manifold_dof("euclidean", (2, 3)) == jcore.manifold_dof("euclidean", (2, 3)) == 6
