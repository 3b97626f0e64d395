"""The camera and landmark factor kernels of the torch port against the JAX
reference, in f64 on the CPU, on the same numpy inputs from a seed: the
residual and every Jacobian of ``reprojection``,
``reprojection_motion_only``, ``reprojection_bal``, ``reprojection_bal9``,
``prior_balcam_pose``, ``landmark_xy_se2``, ``landmark_xyz_se3``,
``bearing_range_se2`` and ``prior_euclidean``, with ``sqrt_info`` batched
(F, m, m) and as one (m, m) matrix; the ``bal_cam9`` retraction; and the
routing of the fused ``ell_assemble`` kernel, which takes none of them.

Tolerance: 1e-12 relative to the largest reference entry of each output.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu import sensors as jsensors
from pyslam_tpu.graph import core as jcore
from pyslam_tpu.lie import se2 as jse2
from pyslam_tpu.lie import se3 as jse3
from pyslam_tpu_torch import sensors as tsensors
from pyslam_tpu_torch.graph import core as tcore
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

F = 9
CAMERA = dict(cu=320.0, cv=240.0, fu=500.0, fv=480.0, b=0.25)


def _close(out, ref, rel=1e-12):
    ref = np.asarray(ref)
    assert tuple(out.shape) == ref.shape and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


def _sqrt_info(rng, m, batched):
    A = rng.normal(size=(F, m, m)) if batched else rng.normal(size=(m, m))
    return A @ np.swapaxes(A, -1, -2) + 2.0 * np.eye(m)


def _se3(rng, scale=0.3):
    return np.array(jse3.exp(jnp.asarray(rng.normal(size=(F, 6)) * scale)))


def _points_seen_from(T, rng, sign):
    """World points whose camera-frame depth is sign * [2, 6]."""
    p_cam = rng.normal(size=(F, 3))
    p_cam[:, 2] = sign * (2.0 + 4.0 * rng.random(F))
    Tinv = np.linalg.inv(T)
    return np.einsum("fij,fj->fi", Tinv[:, :3, :3], p_cam) + Tinv[:, :3, 3]


def _bal_cam(rng, T):
    intr = np.array([700.0, -1e-3, 1e-5]) * (1 + rng.normal(size=(F, 3)) * 0.05)
    return np.concatenate([T.reshape(F, 16), intr], axis=1)


def _inputs(kind, batched, seed=0):
    """(data, vals) as numpy arrays (a camera as its field dict)."""
    rng = np.random.default_rng(seed + len(kind))
    if kind in ("reprojection", "reprojection_motion_only"):
        T = _se3(rng)
        pt = _points_seen_from(T, rng, 1.0)
        data = dict(obs=rng.normal(size=(F, 3)) * 50.0, sqrt_info=_sqrt_info(rng, 3, batched), camera=CAMERA)
        if kind == "reprojection":
            return data, [T, pt]
        return {**data, "pt_w": pt}, [T]
    if kind in ("reprojection_bal", "reprojection_bal9"):
        T = _se3(rng)
        pt = _points_seen_from(T, rng, -1.0)  # BAL cameras look down -z
        data = dict(obs=rng.normal(size=(F, 2)) * 50.0, sqrt_info=_sqrt_info(rng, 2, batched))
        if kind == "reprojection_bal9":
            return data, [_bal_cam(rng, T), pt]
        return {**data, "f": np.full(F, 800.0) + rng.normal(size=F), "k1": np.full(F, -1e-3),
                "k2": np.full(F, 1e-5)}, [T, pt]
    if kind == "prior_balcam_pose":
        return dict(T_obs=_se3(rng, 0.2), sqrt_info=_sqrt_info(rng, 6, batched)), [_bal_cam(rng, _se3(rng))]
    if kind == "landmark_xyz_se3":
        return dict(obs=rng.normal(size=(F, 3)) * 2.0, sqrt_info=_sqrt_info(rng, 3, batched)), \
            [_se3(rng, 0.4), rng.normal(size=(F, 3)) * 2.0]
    if kind == "prior_euclidean":
        return dict(obs=rng.normal(size=(F, 3)), sqrt_info=_sqrt_info(rng, 3, batched)), [rng.normal(size=(F, 3))]
    T = np.asarray(jse2.exp(jnp.asarray(rng.normal(size=(F, 3)) * 0.5)))
    l = rng.normal(size=(F, 2)) * 3.0 + 5.0  # away from the observing origin
    body = np.einsum("fij,fj->fi", T[:, :2, :2], l) + T[:, :2, 2]
    if kind == "bearing_range_se2":
        obs = np.stack([np.arctan2(body[:, 1], body[:, 0]), np.linalg.norm(body, axis=1)], axis=1)
        obs = obs + rng.normal(size=(F, 2)) * 0.05
        obs[0, 0] += 2 * np.pi  # the wrap
    else:
        obs = body + rng.normal(size=(F, 2)) * 0.1
    return dict(obs=obs, sqrt_info=_sqrt_info(rng, 2, batched)), [T, l]


def _both(kind, data, vals, compute_jacobians=True):
    jdata = {k: jsensors.StereoCamera(**v) if k == "camera" else jnp.asarray(v) for k, v in data.items()}
    tdata = {k: tsensors.StereoCamera(**v) if k == "camera" else torch.from_numpy(v.copy()) for k, v in data.items()}
    ref = jcore.FACTOR_KERNELS[kind](jdata, *map(jnp.asarray, vals), compute_jacobians=compute_jacobians)
    out = tcore.FACTOR_KERNELS[kind](tdata, *[torch.from_numpy(v.copy()) for v in vals],
                                     compute_jacobians=compute_jacobians)
    return out, ref


KINDS = {  # kind -> (residual width, Jacobian widths)
    "reprojection": (3, (6, 3)),
    "reprojection_motion_only": (3, (6,)),
    "reprojection_bal": (2, (6, 3)),
    "reprojection_bal9": (2, (9, 3)),
    "prior_balcam_pose": (6, (9,)),
    "landmark_xy_se2": (2, (3, 2)),
    "landmark_xyz_se3": (3, (6, 3)),
    "bearing_range_se2": (2, (3, 2)),
    "prior_euclidean": (3, (3,)),
}


@pytest.mark.parametrize("batched", [True, False], ids=["sqrt_info_batched", "sqrt_info_unbatched"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_factor_kernel_matches_reference(kind, batched):
    m, widths = KINDS[kind]
    (r_t, J_t), (r_j, J_j) = _both(kind, *_inputs(kind, batched))
    assert r_t.shape == (F, m) and [tuple(J.shape) for J in J_t] == [(F, m, w) for w in widths]
    _close(r_t, r_j)
    assert len(J_t) == len(J_j)
    for a, b in zip(J_t, J_j):
        # the reference's prior_euclidean hands an unbatched sqrt_info back as
        # it is; the port gives every Jacobian the factor axis
        _close(a, np.broadcast_to(np.asarray(b), a.shape))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_factor_kernel_without_jacobians(kind):
    data, vals = _inputs(kind, True, seed=5)
    (r_t, J_t), (r_j, J_j) = _both(kind, data, vals, compute_jacobians=False)
    assert J_t is None and J_j is None
    _close(r_t, r_j)
    (r_full, _), _ = _both(kind, data, vals)
    assert torch.equal(r_t, r_full)


def test_bearing_wraps_at_pi():
    """A bearing observed at pi - 0.01 and predicted at -pi + 0.01 gives a
    0.02 rad residual in size, not about 2 pi."""
    ang = np.pi - 0.01
    data = dict(obs=np.array([[ang, 2.0]]), sqrt_info=np.eye(2))
    vals = [np.eye(3)[None], np.array([[2.0 * np.cos(-ang), 2.0 * np.sin(-ang)]])]
    (r_t, _), (r_j, _) = _both("bearing_range_se2", data, vals, compute_jacobians=False)
    _close(r_t, r_j)
    assert abs(r_t[0, 0].item() - 0.02) < 1e-12 and abs(r_t[0, 1].item()) < 1e-12


@pytest.mark.parametrize("kind", ["reprojection", "reprojection_bal"])
def test_point_at_zero_depth_gives_non_finite_values_as_the_reference(kind):
    """No clamp the reference lacks: the LM loop rejects such a step."""
    data, (T, pt) = _inputs(kind, False)
    T[0], pt[0] = np.eye(4), [0.3, -0.2, 0.0]  # depth exactly 0
    (r_t, J_t), (r_j, J_j) = _both(kind, data, [T, pt])
    for a, b in [(r_t, r_j), *zip(J_t, J_j)]:
        assert not np.isfinite(np.asarray(b)[0]).all()
        np.testing.assert_array_equal(np.isfinite(a.numpy()), np.isfinite(np.asarray(b)))
        assert np.isfinite(a.numpy()[1:]).all()


def test_bal_cam9_manifold_matches_reference():
    rng = np.random.default_rng(11)
    cam = _bal_cam(rng, _se3(rng))
    dx = rng.normal(size=(F, 9)) * np.array([0.1] * 6 + [5.0, 1e-4, 1e-6])
    spec_t, spec_j = tcore.MANIFOLDS["bal_cam9"], jcore.MANIFOLDS["bal_cam9"]
    assert (spec_t["dof"], spec_t["shape"]) == (spec_j["dof"], spec_j["shape"]) == (9, (19,))
    assert tcore.manifold_dof("bal_cam9", (19,)) == 9
    out = tcore.retract("bal_cam9", torch.from_numpy(cam), torch.from_numpy(dx))
    _close(out, jcore.retract("bal_cam9", jnp.asarray(cam), jnp.asarray(dx)))
    # the pose part moved by the SE(3) perturbation, the intrinsics by addition
    np.testing.assert_array_equal(out[:, 16:].numpy(), cam[:, 16:] + dx[:, 6:])
    block = tcore.VariableBlock.create("bal_cam9", torch.from_numpy(cam))
    assert (block.n, block.dof) == (F, 9)


def test_factor_batch_carries_a_camera_and_an_unbatched_sqrt_info():
    """``FactorBatch.create`` takes its dtype and device from the
    floating-point tensors of ``data`` and leaves the other values as they
    are; nothing in ``data`` needs the factor axis."""
    data, (T, pt) = _inputs("reprojection", False)
    cam = tsensors.StereoCamera(**data["camera"])
    fb = tcore.FactorBatch.create(
        "reprojection", ("poses", "landmarks"), (np.arange(F), np.arange(F)),
        {"camera": cam, "obs": torch.from_numpy(data["obs"]), "sqrt_info": torch.from_numpy(data["sqrt_info"])},
        loss=None,
    )
    assert fb.data["camera"] is cam and fb.data["sqrt_info"].shape == (3, 3)
    assert fb.weight.dtype == torch.float64 and fb.weight.shape == (F,) and fb.n == F
    blocks = {"poses": tcore.VariableBlock.create("se3", torch.from_numpy(T)),
              "landmarks": tcore.VariableBlock.create("euclidean", torch.from_numpy(pt))}
    r, (J_T, J_pt) = fb.evaluate(blocks)
    (r_ref, _), _ = _both("reprojection", data, [T, pt])
    assert torch.equal(r, r_ref) and J_T.shape == (F, 3, 6) and J_pt.shape == (F, 3, 3)
    with pytest.raises(StopIteration):  # no floating-point tensor to take dtype and device from
        tcore.FactorBatch.create("reprojection", ("poses",), (np.arange(F),), {"camera": cam}, loss=None)
    assert dataclasses.is_dataclass(cam)


def _refused_graphs():
    """Graphs the fused ``ell_assemble`` kernel must not take, by name."""
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import bal, synth
    from pyslam_tpu_torch.losses import L2Loss

    kw = dict(dtype=torch.float64, device="cpu")
    ba = synth.ba_synthetic(n_cams=4, n_pts=12, seed=0)
    bal_data = bal.synthetic_bal(n_cams=4, n_pts=12, seed=0)
    sphere = build.pose_graph(synth.se3_sphere(n_poses=12, seed=0), **kw)
    (between,) = sphere.batches
    rng = np.random.default_rng(2)
    cam9 = tcore.VariableBlock.create("bal_cam9", torch.from_numpy(_bal_cam(rng, _se3(rng))))
    prior9 = tcore.FactorBatch.create(
        "prior_balcam_pose", ("poses",), (np.arange(F),),
        {"T_obs": torch.from_numpy(_se3(rng)), "sqrt_info": torch.eye(6, dtype=torch.float64).expand(F, 6, 6)},
        loss=L2Loss())
    data, (T,) = _inputs("reprojection_motion_only", True)
    motion_only = tcore.FactorBatch.create(
        "reprojection_motion_only", ("poses",), (np.arange(F),),
        {"camera": tsensors.StereoCamera(**data["camera"]),
         **{k: torch.from_numpy(data[k]) for k in ("obs", "sqrt_info", "pt_w")}}, loss=L2Loss())
    one_matrix = dataclasses.replace(between, data={**between.data, "sqrt_info": between.data["sqrt_info"][0]})
    return {
        "ba_graph": build.ba_graph(ba, **kw),
        "bal_graph": build.bal_graph(bal_data, **kw),
        "bal_graph_intrinsics": build.bal_graph(bal_data, optimize_intrinsics=True, **kw),
        "landmark_slam_2d": build.landmark_slam_2d(synth.landmark_slam_2d(n_poses=8, n_landmarks=5, seed=0), **kw),
        "bal_cam9_block_alone": tcore.FactorGraph({"poses": cam9}, [prior9]),
        "se3_block_with_a_camera_factor": tcore.FactorGraph(
            {"poses": tcore.VariableBlock.create("se3", torch.from_numpy(T))}, [motion_only]),
        "between_se3_with_one_sqrt_info": tcore.FactorGraph(sphere.blocks, [one_matrix]),
    }


@pytest.mark.parametrize("name", ["ba_graph", "bal_graph", "bal_graph_intrinsics", "landmark_slam_2d",
                                  "bal_cam9_block_alone", "se3_block_with_a_camera_factor",
                                  "between_se3_with_one_sqrt_info"])
def test_fused_ell_assemble_refuses_camera_and_landmark_graphs(name):
    """``ell_assemble`` takes ``between_se3`` / ``prior_se3`` on one ``se3``
    block with a per-factor ``sqrt_info`` and nothing else; the pose graph
    it does take is the control."""
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import bcsr

    assert bcsr.ell_assemble_batches(_refused_graphs()[name]) is None
    sphere = build.pose_graph(synth.se3_sphere(n_poses=12, seed=0), dtype=torch.float64, device="cpu")
    assert bcsr.ell_assemble_batches(sphere) is not None


def test_between_se3_with_one_sqrt_info_takes_the_general_route():
    """One (6, 6) ``sqrt_info`` for the whole batch assembles to what the
    per-factor copies give, through ``slot_reduce``."""
    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver import bcsr, cuda_ops

    sphere = build.pose_graph(synth.se3_sphere(n_poses=12, seed=0), dtype=torch.float64, device="cpu")
    (between,) = sphere.batches
    S = torch.from_numpy(_sqrt_info(np.random.default_rng(3), 6, False))
    one = tcore.FactorGraph(sphere.blocks, [dataclasses.replace(between, data={**between.data, "sqrt_info": S})])
    each = tcore.FactorGraph(sphere.blocks, [dataclasses.replace(
        between, data={**between.data, "sqrt_info": S.expand(between.n, 6, 6).contiguous()})])
    plan = bcsr.ell_device_plan(bcsr.build_ell_direct(one), "cpu")
    cuda_ops.reset_launches()
    out = bcsr.assemble_ell(one, plan)
    assert cuda_ops.LAUNCHES["slot_reduce_plain"] == 2 and cuda_ops.LAUNCHES["ell_assemble_plain"] == 0
    ref = bcsr.assemble_ell(each, plan)
    assert cuda_ops.LAUNCHES["ell_assemble_plain"] == 1
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10 * b.abs().max().item())
