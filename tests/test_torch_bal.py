"""BAL file I/O of the torch port (``pyslam_tpu_torch/io/bal.py``, numpy
only) and the camera / landmark graph builders (``ba_graph``, ``bal_graph``,
``landmark_slam_2d``) against the JAX reference, on the CPU.

Tolerances: the port's ``synthetic_bal`` and ``perturbed`` give arrays
identical to the reference's (the same numpy code from the same seed); a
file written by either package reads back within 1e-12 through either
reader (17 significant digits in the text); the builders give identical
values, indices and measurement arrays in f64, and graphs whose chi2 agrees
to 1e-12 relative; ``graph_from_numpy`` carries a reference graph across
unchanged.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import to_port

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.io import bal as jbal
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu_torch import sensors as tsensors
from pyslam_tpu_torch.graph import build as tbuild
from pyslam_tpu_torch.graph import convert
from pyslam_tpu_torch.io import bal as tbal
from pyslam_tpu_torch.io import synth as tsynth
from pyslam_tpu_torch.losses import HuberLoss as THuber
from pyslam_tpu_torch.losses import L2Loss as TL2
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

FIELDS = [f.name for f in dataclasses.fields(tbal.BALData)]
CPU = dict(dtype=torch.float64, device="cpu")


def _same_data(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


# --------------------------------------------------------------------------
# io/bal.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(n_cams=4, n_pts=20, seed=0), dict(n_cams=6, n_pts=50, pixel_std=0.0, seed=3)],
                         ids=["noisy", "exact"])
def test_synthetic_bal_and_perturbed_are_the_reference_arrays(kw):
    assert FIELDS == [f.name for f in dataclasses.fields(jbal.BALData)]
    jd, td = jbal.synthetic_bal(**kw), tbal.synthetic_bal(**kw)
    _same_data(td, jd)
    _same_data(tbal.perturbed(td), jbal.perturbed(jd))
    _same_data(tbal.perturbed(td, pose_noise=(0.1, 0.02), pt_noise=0.2, seed=9),
               jbal.perturbed(jd, pose_noise=(0.1, 0.02), pt_noise=0.2, seed=9))
    assert td.T.shape == (kw["n_cams"], 4, 4) and td.obs.shape == (len(td.cam_idx), 2)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "reference"), ("reference", "port")])
def test_bal_file_round_trip(tmp_path, writer, reader):
    mods = {"port": tbal, "reference": jbal}
    data = tbal.synthetic_bal(n_cams=4, n_pts=20, seed=0)
    path = str(tmp_path / "problem.bal")
    mods[writer].write_bal(path, data)
    back = mods[reader].read_bal(path)
    for name in ("T", "intrinsics", "pts", "obs"):
        np.testing.assert_allclose(getattr(back, name), getattr(data, name), rtol=0, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(back.cam_idx, data.cam_idx)
    np.testing.assert_array_equal(back.pt_idx, data.pt_idx)
    header = open(path).readline().split()
    assert [int(v) for v in header] == [4, 20, len(data.cam_idx)]


def test_both_writers_give_the_same_file(tmp_path):
    data = tbal.synthetic_bal(n_cams=3, n_pts=10, seed=2)
    tbal.write_bal(str(tmp_path / "port.bal"), data)
    jbal.write_bal(str(tmp_path / "reference.bal"), data)
    assert (tmp_path / "port.bal").read_text() == (tmp_path / "reference.bal").read_text()


def test_rotation_near_pi_round_trips(tmp_path):
    """The angle-axis form of the file at a rotation within 1e-6 of pi."""
    data = tbal.synthetic_bal(n_cams=2, n_pts=8, seed=0)
    w = np.array([0.6, 0.0, 0.8]) * (np.pi - 1e-6)
    data.T[1, :3, :3] = tbal._rodrigues_to_R(w[None])[0]
    path = str(tmp_path / "pi.bal")
    tbal.write_bal(path, data)
    np.testing.assert_allclose(tbal.read_bal(path).T, data.T, rtol=0, atol=1e-9)


# --------------------------------------------------------------------------
# Builders
# --------------------------------------------------------------------------


def _assert_same_graph(tg, jg):
    assert list(tg.blocks) == list(jg.blocks)
    for name, jb in jg.blocks.items():
        tb = tg.blocks[name]
        assert (tb.kind, tb.n, tb.dof) == (jb.kind, jb.n, jb.dof)
        np.testing.assert_array_equal(tb.values.numpy(), np.asarray(jb.values))
        np.testing.assert_array_equal(tb.const_mask.numpy(), np.asarray(jb.const_mask))
    assert len(tg.batches) == len(jg.batches)
    for tf, jf in zip(tg.batches, jg.batches):
        assert (tf.kind, tf.slots, type(tf.loss).__name__) == (jf.kind, jf.slots, type(jf.loss).__name__)
        assert dataclasses.asdict(tf.loss) == dataclasses.asdict(jf.loss)
        for a, b in zip(tf.indices, jf.indices):
            assert a.dtype == torch.int64
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert sorted(tf.data) == sorted(jf.data)
        for k, v in jf.data.items():
            if dataclasses.is_dataclass(v):
                assert type(tf.data[k]).__name__ == type(v).__name__
                assert dataclasses.asdict(tf.data[k]) == dataclasses.asdict(v)
            else:
                assert tuple(tf.data[k].shape) == np.asarray(v).shape  # unbatched stays unbatched
                np.testing.assert_array_equal(tf.data[k].numpy(), np.asarray(v))
        np.testing.assert_array_equal(tf.weight.numpy(), np.asarray(jf.weight))
    np.testing.assert_allclose(tg.chi2().item(), float(jg.chi2()), rtol=1e-12)


@pytest.mark.parametrize("init", ["noisy", "gt"])
def test_ba_graph_matches_reference(init):
    jg = jbuild.ba_graph(jsynth.ba_synthetic(n_cams=5, n_pts=30, seed=7), dtype=jnp.float64, init=init)
    tg = tbuild.ba_graph(tsynth.ba_synthetic(n_cams=5, n_pts=30, seed=7), init=init, **CPU)
    _assert_same_graph(tg, jg)
    (fb,) = tg.batches
    assert fb.data["sqrt_info"].shape == (3, 3) and isinstance(fb.data["camera"], tsensors.StereoCamera)
    assert tg.blocks["poses"].const_mask.tolist() == [True] + [False] * 4
    _assert_same_graph(to_port(jg), jg)  # and a reference graph crosses as it is


@pytest.mark.parametrize("optimize_intrinsics", [False, True], ids=["fixed_intrinsics", "bal_cam9"])
@pytest.mark.parametrize("anchor_first", [True, False])
def test_bal_graph_matches_reference(optimize_intrinsics, anchor_first):
    data = tbal.perturbed(tbal.synthetic_bal(n_cams=5, n_pts=40, seed=7))
    kw = dict(pixel_std=0.5, anchor_first=anchor_first, optimize_intrinsics=optimize_intrinsics)
    jg = jbuild.bal_graph(data, dtype=jnp.float64, **kw)
    tg = tbuild.bal_graph(data, **kw, **CPU)
    _assert_same_graph(tg, jg)
    assert tg.batches[0].data["sqrt_info"].shape == (2, 2)
    if optimize_intrinsics:
        assert tg.blocks["poses"].kind == "bal_cam9" and tg.blocks["poses"].values.shape == (5, 19)
        assert not tg.blocks["poses"].const_mask.any()  # the anchor is a pose-only prior
        assert [fb.kind for fb in tg.batches] == ["reprojection_bal9"] + ["prior_balcam_pose"] * anchor_first
    else:
        assert tg.blocks["poses"].const_mask.tolist() == [anchor_first] + [False] * 4
    _assert_same_graph(to_port(jg), jg)


def test_exact_bal_observations_give_zero_cost():
    data = tbal.synthetic_bal(n_cams=4, n_pts=30, pixel_std=0.0, seed=1)
    for optimize_intrinsics in (False, True):
        g = tbuild.bal_graph(data, optimize_intrinsics=optimize_intrinsics, **CPU)
        assert g.chi2().item() < 1e-10


@pytest.mark.parametrize("obs_type", ["bearing_range", "xy"])
@pytest.mark.parametrize("init", ["noisy", "gt"])
def test_landmark_slam_2d_matches_reference(obs_type, init):
    kw = dict(n_poses=12, n_landmarks=8, obs_type=obs_type, seed=4)
    jg = jbuild.landmark_slam_2d(jsynth.landmark_slam_2d(**kw), dtype=jnp.float64, init=init)
    tg = tbuild.landmark_slam_2d(tsynth.landmark_slam_2d(**kw), init=init, **CPU)
    _assert_same_graph(tg, jg)
    assert [fb.kind for fb in tg.batches] == [
        "bearing_range_se2" if obs_type == "bearing_range" else "landmark_xy_se2", "between_se2"]
    assert (tg.blocks["poses"].dof, tg.blocks["landmarks"].dof) == (3, 2)
    free = tbuild.landmark_slam_2d(tsynth.landmark_slam_2d(**kw), anchor_first=False, **CPU)
    assert not free.blocks["poses"].const_mask.any()
    _assert_same_graph(to_port(jg), jg)


def test_builders_take_a_loss_and_default_to_f32():
    data = tsynth.ba_synthetic(n_cams=3, n_pts=10, seed=0)
    g = tbuild.ba_graph(data, loss=THuber(1.5), device="cpu")
    assert g.blocks["poses"].values.dtype == g.batches[0].weight.dtype == torch.float32
    assert g.batches[0].loss == THuber(1.5)
    bal_data = tbal.synthetic_bal(n_cams=3, n_pts=10, seed=0)
    g9 = tbuild.bal_graph(bal_data, loss=THuber(1.5), optimize_intrinsics=True, device="cpu")
    assert g9.blocks["poses"].values.dtype == torch.float32
    assert [fb.loss for fb in g9.batches] == [THuber(1.5), TL2()]  # the anchor prior stays quadratic
    g2 = tbuild.landmark_slam_2d(tsynth.landmark_slam_2d(n_poses=6, n_landmarks=4, seed=0), device="cpu")
    assert g2.blocks["landmarks"].values.dtype == torch.float32


def test_graph_from_numpy_rejects_an_unknown_camera():
    block = dict(kind="se3", values=np.eye(4)[None], const_mask=np.zeros(1, bool))
    batch = dict(kind="reprojection_motion_only", slots=("poses",), indices=[np.zeros(1, np.int64)],
                 data={"obs": np.zeros((1, 3)), "sqrt_info": np.eye(3), "pt_w": np.ones((1, 3)),
                       "camera": ("FisheyeCamera", {})},
                 weight=np.ones(1), loss=("L2Loss", {}))
    with pytest.raises(ValueError, match="unknown camera"):
        convert.graph_from_numpy({"poses": block}, [batch], torch.float64, device="cpu")
    batch["data"]["camera"] = ("RGBDCamera", dict(cu=1.0, cv=2.0, fu=3.0, fv=4.0))
    g = convert.graph_from_numpy({"poses": block}, [batch], torch.float64, device="cpu")
    assert g.batches[0].data["camera"] == tsensors.RGBDCamera(1.0, 2.0, 3.0, 4.0)
    assert g.batches[0].data["sqrt_info"].shape == (3, 3)
