"""``ell_assemble`` of the torch port, on the CPU in f64: the kernel's plain
version (``ell_assemble_plain``, which follows the kernel's two stages on the
kernel's own plan tables) and ``assemble_ell`` through its dispatch against
the JAX ``assemble_ell``, on the same numpy inputs.

The problem is ``testing.se3_stress_graph``: ``se3_sphere(60, seed=11)``
with loop closures, SE(3) priors, zero-weight padding factors, pose 0 and an
interior pose frozen, a general 6x6 ``sqrt_info`` and error rotations of
exactly 0, below 1e-4 and within 1e-3 of pi.  Tolerances: He and g within
1e-10 of their largest entry, chi2 within 1e-12 relative; a solve takes the
reference's iterations, stop code and accept sequence, chi2 within 1e-8 and
poses within 1e-6.  The CUDA kernel is held against the plain version on the
card by ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import assert_rel, to_port

from pyslam_tpu import losses as jlosses
from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.graph.core import FactorBatch as JFactorBatch
from pyslam_tpu.graph.core import FactorGraph as JFactorGraph
from pyslam_tpu.graph.core import VariableBlock as JVariableBlock
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import bcsr as jb
from pyslam_tpu.solver import lm as jlm
from pyslam_tpu_torch import losses as tlosses
from pyslam_tpu_torch.solver import bcsr as tb
from pyslam_tpu_torch.solver import cuda_ops
from pyslam_tpu_torch.solver import lm as tlm
from pyslam_tpu_torch.testing import se3_stress_arrays, se3_stress_graph

# the losses the kernel evaluates: (class name, fields)
LOSSES = {
    "l2": ("L2Loss", {}),
    "l1": ("L1Loss", {}),
    "cauchy": ("CauchyLoss", {"k": 2.0}),
    "huber": ("HuberLoss", {"k": 1.0}),
    "tukey": ("TukeyLoss", {"k": 3.0}),
    "student_t": ("TDistributionLoss", {"nu": 5.0, "scale": 1.5}),
}


def jax_stress_graph(loss):
    """The stress graph in the reference's classes, from the same arrays."""
    name, fields = LOSSES[loss] if isinstance(loss, str) else loss
    blocks, batches = se3_stress_arrays()
    b = blocks["poses"]
    j_blocks = {"poses": JVariableBlock.create(b["kind"], jnp.asarray(b["values"]), jnp.asarray(b["const_mask"]))}
    j_batches = [
        JFactorBatch.create(
            kind=fb["kind"], slots=fb["slots"], indices=fb["indices"],
            data={k: jnp.asarray(v) for k, v in fb["data"].items()},
            loss=jlosses.L2Loss() if fb["kind"] == "prior_se3" else getattr(jlosses, name)(**fields),
            weight=jnp.asarray(fb["weight"]),
        )
        for fb in batches
    ]
    return JFactorGraph(j_blocks, j_batches)


def port_stress_graph(loss):
    name, fields = LOSSES[loss] if isinstance(loss, str) else loss
    return se3_stress_graph(loss=getattr(tlosses, name)(**fields), device="cpu")


def _kernel_args(tg):
    dplan = tb.ell_device_plan(tb.build_ell_direct(tg), "cpu")
    block = tg.blocks["poses"]
    return [block.values, block.const_mask, tb.ell_assemble_batches(tg), dplan.cols, dplan.a_idx, dplan.a_entries,
            dplan.h_offsets, dplan.a_first]


def _assert_matches(out, ref):
    (He, g, chi2), (He_j, g_j, chi2_j) = out, ref
    assert_rel(He, He_j)
    assert_rel(g, g_j)
    assert chi2.shape == () and chi2.dtype == torch.float64
    np.testing.assert_allclose(chi2.item(), float(chi2_j), rtol=1e-12)


def test_stress_graph_is_the_same_problem_in_both_packages():
    jg, tg = jax_stress_graph("l2"), port_stress_graph("l2")
    np.testing.assert_array_equal(tg.blocks["poses"].values.numpy(), np.asarray(jg.blocks["poses"].values))
    np.testing.assert_array_equal(tg.blocks["poses"].const_mask.numpy(), np.asarray(jg.blocks["poses"].const_mask))
    assert tg.blocks["poses"].const_mask.nonzero().flatten().tolist() == [0, 30]
    for tf, jf in zip(tg.batches, jg.batches):
        assert (tf.kind, tf.slots) == (jf.kind, jf.slots)
        assert all(i.dtype == torch.int64 for i in tf.indices)
        for k in jf.data:
            np.testing.assert_array_equal(tf.data[k].numpy(), np.asarray(jf.data[k]))
        np.testing.assert_array_equal(tf.weight.numpy(), np.asarray(jf.weight))
    assert_rel(tg.chi2(), jg.chi2())


@pytest.mark.parametrize("route", ["dispatch", "plain"])
@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_ell_assemble_matches_reference(loss, route):
    jg, tg = jax_stress_graph(loss), port_stress_graph(loss)
    ref = jb.assemble_ell(jg, jb.build_ell_direct(jg))
    cuda_ops.reset_launches()
    if route == "dispatch":
        out = tb.assemble_ell(tg, tb.ell_device_plan(tb.build_ell_direct(tg), "cpu"))
    else:
        out = cuda_ops.ell_assemble_plain(*_kernel_args(tg))
    # CPU tensors: the plain version, and not the general route
    assert cuda_ops.LAUNCHES["ell_assemble_plain"] == 1 and cuda_ops.LAUNCHES["ell_assemble"] == 0
    assert cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    _assert_matches(out, ref)


def test_ell_assemble_matches_reference_on_the_sphere_graph():
    """The plain pose graph of the other parity tests, one batch."""
    jg = jbuild.pose_graph(jsynth.se3_sphere(n_poses=60, seed=11), dtype=jnp.float64)
    tg = to_port(jg)
    out = tb.assemble_ell(tg, tb.ell_device_plan(tb.build_ell_direct(tg), "cpu"))
    _assert_matches(out, jb.assemble_ell(jg, jb.build_ell_direct(jg)))


def test_frozen_poses_get_identity_rows():
    tg = port_stress_graph("cauchy")
    plan = tb.build_ell_direct(tg)
    He, g, _ = tb.assemble_ell(tg, tb.ell_device_plan(plan, "cpu"))
    for frozen in (0, 30):
        assert torch.equal(He[frozen, 0], torch.eye(6, dtype=torch.float64))
        assert not He[frozen, 1:].any() and not g[6 * frozen : 6 * frozen + 6].any()
    r, k = np.nonzero((plan.cols == 30) & (np.arange(plan.nb)[:, None] != 30))
    assert len(r) and not He[r, k].any()  # and a zero column at their neighbours
    free = [n for n in range(plan.nb) if n not in (0, 30)]
    assert He[free, 0].diagonal(dim1=-2, dim2=-1).min() > 0


def test_plan_tables_cover_every_role_once_in_slot_plan_order():
    tg = port_stress_graph("l2")
    plan = tb.build_ell_direct(tg)
    hp, _ = tb.build_slot_plans(plan)
    idx, entries, first = tb.build_assemble_tables(plan, hp)
    assert first == (0, *np.cumsum([fb.n for fb in tg.batches]).tolist())
    assert idx.dtype == entries.dtype == np.int32 and idx.shape == (first[-1], 2)
    for b, fb in enumerate(tg.batches):
        rows = idx[first[b] : first[b + 1]]
        np.testing.assert_array_equal(rows[:, 0], fb.indices[0].numpy())
        np.testing.assert_array_equal(rows[:, 1], fb.indices[-1].numpy())
    # the contributions as build_slot_plans stacks them, and where each goes
    code, dest = [], []
    for b, batch_entries in enumerate(plan.maps):
        factor = first[b] + np.arange(first[b + 1] - first[b])
        for a, bb, pos_ab, pos_ba in batch_entries:
            code.append(factor << 3 | a << 2 | bb << 1)
            dest.append(pos_ab)
            if pos_ba is not None:
                code.append(factor << 3 | a << 2 | bb << 1 | 1)
                dest.append(pos_ba)
    code, dest = np.concatenate(code), np.concatenate(dest)
    n_between, n_prior = first[1] + first[3] - first[2], first[2] - first[1]
    assert len(code) == 4 * n_between + n_prior == len(entries)
    assert len(set(code.tolist())) == len(code)  # every (factor, role) is its own code
    assert sorted(entries.tolist()) == sorted(code.tolist())  # and appears exactly once
    number = {c: n for n, c in enumerate(code.tolist())}
    for s in range(plan.nb * plan.K):
        seg = entries[hp.offsets[s] : hp.offsets[s + 1]].tolist()
        assert all(dest[number[c]] == s for c in seg)
        numbers = [number[c] for c in seg]
        assert numbers == sorted(numbers) == hp.perm[hp.offsets[s] : hp.offsets[s + 1]].tolist()


def _se2_graph():
    jg = jbuild.pose_graph(jsynth.se2_loop(n_poses=30, n_loops=4, seed=0), dtype=jnp.float64)
    return jg, to_port(jg)


def _sim3_graph():
    jg = jbuild.pose_graph(jsynth.sim3_loop(n_poses=30, n_loops=3, scale_drift=0.005, seed=0), dtype=jnp.float64)
    return jg, to_port(jg)


def _estimated_scale_graph():
    loss = ("TDistributionLoss", {"nu": 5.0, "scale": None})
    return jax_stress_graph(loss), port_stress_graph(loss)


@pytest.mark.parametrize("make", [_se2_graph, _sim3_graph, _estimated_scale_graph])
def test_other_graphs_take_the_general_route(make):
    """SE(2), Sim(3) and the loss that estimates its scale from all
    residuals are not the kernel's: ``slot_reduce`` twice, the same result."""
    jg, tg = make()
    assert tb.ell_assemble_batches(tg) is None
    cuda_ops.reset_launches()
    out = tb.assemble_ell(tg, tb.ell_device_plan(tb.build_ell_direct(tg), "cpu"))
    assert cuda_ops.LAUNCHES["slot_reduce_plain"] == 2 and cuda_ops.LAUNCHES["ell_assemble_plain"] == 0
    _assert_matches(out, jb.assemble_ell(jg, jb.build_ell_direct(jg)))


def test_dispatch_reads_the_graph_only():
    tg = port_stress_graph("huber")
    batches = tb.ell_assemble_batches(tg)
    assert [b.n_slots for b in batches] == [2, 1, 2]
    assert [type(b.loss).__name__ for b in batches] == ["HuberLoss", "L2Loss", "HuberLoss"]
    assert batches[0].T_obs is tg.batches[0].data["T_obs"] and batches[1].weight is tg.batches[1].weight
    many = dataclasses.replace(tg, batches=tg.batches * 3)  # 9 batches: more than the kernel's table
    assert tb.ell_assemble_batches(many) is None
    assert cuda_ops.kernel_loss(tlosses.TDistributionLoss()) is None
    assert cuda_ops.kernel_loss(tlosses.CauchyLoss(2.0)) == (2, 2.0, 2.0, 0.0)


BAD_INPUTS = ["poses_shape", "poses_half", "poses_noncontiguous", "const_mask_int", "cols_int64", "idx_int64",
              "entries_2d", "offsets_length", "first_length", "first_descending", "too_many_batches",
              "loss_not_taken", "T_obs_shape", "weight_dtype", "three_slots"]


@pytest.mark.parametrize("case", BAD_INPUTS)
def test_ell_assemble_rejects_bad_inputs(case):
    poses, const_mask, batches, cols, idx, entries, offsets, first = _kernel_args(port_stress_graph("l2"))
    if case == "poses_shape":
        poses = poses[:, :3]
    elif case == "poses_half":
        poses = poses.half()
    elif case == "poses_noncontiguous":
        poses = poses.transpose(1, 2)
    elif case == "const_mask_int":
        const_mask = const_mask.int()
    elif case == "cols_int64":
        cols = cols.long()
    elif case == "idx_int64":
        idx = idx.long()
    elif case == "entries_2d":
        entries = entries[:, None]
    elif case == "offsets_length":
        offsets = offsets[:-1]
    elif case == "first_length":
        first = first[:-1]
    elif case == "first_descending":
        first = (0, first[2], first[1], first[3])
    elif case == "too_many_batches":
        batches, first = batches * 3, (0,) * 10
    elif case == "loss_not_taken":
        batches = [batches[0]._replace(loss=tlosses.TDistributionLoss())] + batches[1:]
    elif case == "T_obs_shape":
        batches = [batches[0]._replace(T_obs=batches[0].T_obs[:-1])] + batches[1:]
    elif case == "weight_dtype":
        batches = [batches[0]._replace(weight=batches[0].weight.float())] + batches[1:]
    else:
        batches = [batches[0]._replace(n_slots=3)] + batches[1:]
    with pytest.raises((TypeError, ValueError)):
        cuda_ops.ell_assemble(poses, const_mask, batches, cols, idx, entries, offsets, first)


def test_plan_without_one_or_two_slot_batches_has_no_tables():
    """A batch whose diagonal entries are not slots {0} or {0, 1} is not the
    kernel's: no tables, and ``assemble_ell`` takes the general route."""
    tg = port_stress_graph("l2")
    plan = tb.build_ell_direct(tg)
    hp, _ = tb.build_slot_plans(plan)
    a, b, pos_ab, _ = plan.maps[1][0]
    odd = dataclasses.replace(plan, maps=(plan.maps[0], ((a + 2, b + 2, pos_ab, None),), plan.maps[2]))
    assert tb.build_assemble_tables(odd, hp) is None
    short = dataclasses.replace(plan, maps=plan.maps[:2])
    with pytest.raises(ValueError, match="contributions"):
        tb.build_assemble_tables(short, hp)


@pytest.mark.parametrize("loss,method", [("l2", "lm"), ("cauchy", "lm"), ("l2", "gn"), ("huber", "dogleg")])
def test_solve_ell_through_ell_assemble_matches_reference(loss, method):
    jg, tg = jax_stress_graph(loss), port_stress_graph(loss)
    kw = dict(method=method, max_iters=12)
    js, ji = jb.solve_ell(jg, jlm.Options(**kw))
    cuda_ops.reset_launches()
    ts, ti = tb.solve_ell(tg, tlm.Options(**kw))
    # one assembly before the loop and one per trial point, none by the general route
    assert cuda_ops.LAUNCHES["ell_assemble_plain"] == ti.iterations + 1
    assert cuda_ops.LAUNCHES["slot_reduce_plain"] == 0
    assert (ti.iterations, ti.status) == (int(ji.iterations), int(ji.status))
    np.testing.assert_array_equal(ti.accepted.numpy(), np.asarray(ji.accepted))
    np.testing.assert_allclose(ti.chi2.item(), float(ji.chi2), rtol=1e-8)
    np.testing.assert_allclose(
        ts.blocks["poses"].values.numpy(), np.asarray(js.blocks["poses"].values), rtol=0, atol=1e-6
    )
