"""The port's dense VO pipelines against the JAX reference on the same numpy
frames (64 x 48, 2 to 3 levels, float32 in both): keyframe levels equal
after the cast to float32, trajectories within 1e-4 in translation (m)
and rotation (rad) per frame with the same keyframe decisions, uint8
against float frames, prefetched against plain, ``track_batch`` against
the reference's and against the sequential run, the affine kernel through
an exposure change; and the port's copies of the synthetic VO frames."""

import os
import sys

import numpy as np
import pytest
import torch

from pyslam_tpu.pipelines import DenseRGBDPipeline as JaxRGBDPipeline
from pyslam_tpu.pipelines import DenseStereoPipeline as JaxStereoPipeline
from pyslam_tpu.pipelines.keyframes import DenseRGBDKeyframe as JaxRGBDKeyframe
from pyslam_tpu.pipelines.keyframes import DenseStereoKeyframe as JaxStereoKeyframe
from pyslam_tpu.sensors import RGBDCamera as JaxRGBD
from pyslam_tpu.sensors import StereoCamera as JaxStereo
from pyslam_tpu_torch import testing
from pyslam_tpu_torch.pipelines import DenseRGBDPipeline, DenseStereoPipeline
from pyslam_tpu_torch.pipelines.keyframes import DenseRGBDKeyframe, DenseStereoKeyframe
from pyslam_tpu_torch.sensors import RGBDCamera, StereoCamera
from pyslam_tpu_torch.testing import PLANE_CAM, render_rgbd, render_stereo
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4  # per frame, translation (m) and rotation (rad), float32 in both packages
STEREO = dict(b=0.3, **PLANE_CAM)


def _gap(a, b):
    """(translation gap, rotation gap) of two stacks of poses, the largest
    over the frames."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dR = np.einsum("nji,njk->nik", a[:, :3, :3], b[:, :3, :3])
    # the angle from the skew part (sin theta): the trace's arccos loses
    # half the digits near 0
    skew = 0.5 * (dR - dR.transpose(0, 2, 1))
    ang = np.arcsin(np.clip(np.linalg.norm(skew[:, [2, 0, 1], [1, 2, 0]], axis=-1), 0.0, 1.0))
    return float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max()), float(ang.max())


def _hold(out, ref, tol=TOL):
    t, r = _gap(out, ref)
    assert t <= tol and r <= tol, (t, r)


def _path(n, scale=1.0):
    return [scale * np.array([0.02 * k, 0.01 * np.sin(k / 2), 0.005 * k]) for k in range(n)]


def _pair(jax_cls, torch_cls, cam, **kw):
    jcam = (JaxStereo if "b" in cam else JaxRGBD)(**cam)
    tcam = (StereoCamera if "b" in cam else RGBDCamera)(**cam)
    return jax_cls(jcam, **kw), torch_cls(tcam, device="cpu", **kw)


@pytest.fixture(scope="module")
def rgbd_runs():
    """The RGB-D sequence through both packages, with a keyframe switch."""
    frames = [render_rgbd(t) for t in _path(6)]
    ref, out = _pair(JaxRGBDPipeline, DenseRGBDPipeline, PLANE_CAM, pyrlevels=3, keyframe_trans_thresh=0.05)
    for im, depth in frames:
        ref.track(im, depth)
        out.track(im, depth)
    return frames, ref, out


# ---- keyframes ----


@pytest.mark.parametrize("budget", [None, 600])
@pytest.mark.parametrize("stereo", [False, True], ids=["rgbd", "stereo"])
def test_keyframe_levels_match_reference(stereo, budget):
    if stereo:
        im_l, im_r, disp = render_stereo(np.zeros(3))
        disp = disp.copy()
        disp[:6, :10] = np.nan
        ref = JaxStereoKeyframe(im_l, im_r, JaxStereo(**STEREO), pyrlevels=3, disp=disp, pixel_budget=budget)
        out = DenseStereoKeyframe(im_l, im_r, StereoCamera(**STEREO), pyrlevels=3, disp=disp, pixel_budget=budget,
                                  device="cpu")
    else:
        im, depth = render_rgbd(np.zeros(3))
        depth = depth.copy()
        depth[-4:] = np.nan
        ref = JaxRGBDKeyframe(im, depth, JaxRGBD(**PLANE_CAM), pyrlevels=3, min_grad=0.002, pixel_budget=budget)
        out = DenseRGBDKeyframe(im, depth, RGBDCamera(**PLANE_CAM), pyrlevels=3, min_grad=0.002, pixel_budget=budget,
                                device="cpu")
    assert len(out.levels) == len(ref.levels) == 3
    for lo, lr in zip(out.levels, ref.levels):
        assert lo.camera == type(lo.camera)(**{k: getattr(lr.camera, k) for k in vars(lr.camera)})
        for key in ("im", "pt_ref", "I_ref", "mask"):
            t = getattr(lo, key)
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(lr, key)), err_msg=key)


# ---- tracking ----


def test_rgbd_trajectory_and_keyframes_match_reference(rgbd_runs):
    _, ref, out = rgbd_runs
    assert len(out.keyframes) == len(ref.keyframes) == 2
    _hold(np.stack(out.T_c_w), np.stack(ref.T_c_w))
    truth = -np.stack(_path(6))
    np.testing.assert_allclose(np.stack(out.T_c_w)[:, :3, 3], truth, atol=3e-3)


def test_keyframe_decisions_match_reference(rgbd_runs):
    """Each keyframe is made at the same frame in both packages."""
    _, ref, out = rgbd_runs

    def frames_of(pipe):
        return [next(i for i, T in enumerate(pipe.T_c_w) if np.array_equal(T, kf.T_w)) for kf in pipe.keyframes]

    assert frames_of(out) == frames_of(ref)


def test_stepwise_levels_give_the_fused_pose(rgbd_runs):
    frames, _, out = rgbd_runs
    kf = out.keyframes[-1]
    guess = np.asarray(out.T_c_w[-1] @ np.linalg.inv(kf.T_w), np.float32)
    fused = out._compute_frame_to_keyframe_pose(kf, frames[-1][0].astype(np.float32), guess)
    step = out._compute_frame_to_keyframe_pose_stepwise(kf, frames[-1][0].astype(np.float32), guess)
    np.testing.assert_array_equal(step, fused)


def test_stereo_trajectory_matches_reference():
    frames = [render_stereo(t) for t in _path(5)]
    ref, out = _pair(JaxStereoPipeline, DenseStereoPipeline, STEREO, pyrlevels=3, keyframe_trans_thresh=10.0)
    for k, (im_l, im_r, disp) in enumerate(frames):
        ref.track(im_l, im_r, disp=disp if k == 0 else None)
        out.track(im_l, im_r, disp=disp if k == 0 else None)
    _hold(np.stack(out.T_c_w), np.stack(ref.T_c_w))


def test_stereo_pipeline_with_the_tpu_matcher():
    """``matcher="tpu"``: the keyframe's disparity from the port's block
    matcher; the reference's test scene (96 x 192, a fronto-parallel plane
    at constant disparity)."""
    rng = np.random.default_rng(1)
    H, W, b, fu, Z, pad = 96, 192, 0.3, 160.0, 4.0, 64
    cam = dict(cu=(W - 1) / 2, cv=(H - 1) / 2, fu=fu, fv=fu, b=b, w=W, h=H)
    tex = rng.uniform(0.2, 0.8, (H, W + 2 * pad))
    tex = np.apply_along_axis(lambda r: np.convolve(r, np.ones(3) / 3, mode="same"), 1, tex)

    def pair(shift):
        left = tex[:, pad + shift: pad + shift + W]
        return left, tex[:, pad + shift + int(round(fu * b / Z)):][:, :W]

    ref, out = _pair(JaxStereoPipeline, DenseStereoPipeline, cam, pyrlevels=2, matcher="tpu")
    for shift in (0, 1):
        ref.track(*pair(shift))
        out.track(*pair(shift))
    for lo, lr in zip(out.keyframes[0].levels, ref.keyframes[0].levels):
        np.testing.assert_array_equal(lo.mask.numpy(), np.asarray(lr.mask))
    _hold(np.stack(out.T_c_w), np.stack(ref.T_c_w))
    assert abs(out.T_c_w[-1][0, 3] + Z / fu) < 0.3 * Z / fu


@pytest.fixture(scope="module")
def uint8_frames():
    """``tests/test_pipelines.py``'s uint8 case: a random texture rolled by
    a pixel a frame."""
    W, H = 64, 48
    cam = dict(cu=(W - 1) / 2, cv=(H - 1) / 2, fu=60.0, fv=60.0, w=W, h=H)
    base = np.random.default_rng(0).uniform(0.2, 0.8, (H, W))
    frames = [(np.roll(base, k, axis=1), np.full((H, W), 3.0)) for k in range(3)]
    return cam, frames


def test_uint8_frames_match_reference_and_float(uint8_frames):
    cam, frames = uint8_frames
    runs = {}
    for to_u8 in (False, True):
        ref, out = _pair(JaxRGBDPipeline, DenseRGBDPipeline, cam, pyrlevels=2)
        for im, depth in frames:
            if to_u8:
                im = np.clip(im * 255.0, 0, 255).astype(np.uint8)
            ref.track(im, depth)
            out.track(im, depth)
        _hold(np.stack(out.T_c_w), np.stack(ref.T_c_w))
        runs[to_u8] = np.stack(out.T_c_w)
    np.testing.assert_allclose(runs[True], runs[False], atol=5e-2)  # quantization-level agreement


def test_prefetched_frames_match_plain_track():
    """``prefetch(im)`` then ``track(handle)`` is ``track(im)`` with the upload
    moved earlier: the same trajectory, bit for bit."""
    cam = dict(PLANE_CAM, fu=90.0, fv=90.0)
    frames = []
    for t in _path(5, scale=1.5):
        im, depth = render_rgbd(t, cam)
        frames.append(((np.clip(im, 0, 1) * 255).astype(np.uint8), depth.astype(np.float32)))
    ref, plain = _pair(JaxRGBDPipeline, DenseRGBDPipeline, cam, pyrlevels=2)
    pre = DenseRGBDPipeline(RGBDCamera(**cam), pyrlevels=2, device="cpu")
    for im, depth in frames:
        ref.track(im, depth)
        plain.track(im, depth)
    pre.track(*frames[0])
    h = pre.prefetch(frames[1][0])
    for k in range(1, len(frames)):
        h_next = pre.prefetch(frames[k + 1][0]) if k + 1 < len(frames) else None
        pre.track(h, frames[k][1])
        h = h_next
    np.testing.assert_array_equal(np.stack(pre.T_c_w), np.stack(plain.T_c_w))
    _hold(np.stack(plain.T_c_w), np.stack(ref.T_c_w))


@pytest.mark.parametrize("stereo", [False, True], ids=["rgbd", "stereo"])
def test_track_batch_matches_reference_and_sequential(stereo):
    """K frames against one keyframe in one ``solve_batched`` a level: each
    frame with its own frozen Student-t scale and stop code."""
    steps = _path(5)
    cam = STEREO if stereo else PLANE_CAM
    cls = (JaxStereoPipeline, DenseStereoPipeline) if stereo else (JaxRGBDPipeline, DenseRGBDPipeline)
    frames = [render_stereo(t) if stereo else render_rgbd(t) for t in steps]
    first = frames[0][:2]
    kw = dict(disp=frames[0][2]) if stereo else {}
    ref, out = _pair(*cls, cam, pyrlevels=3, keyframe_trans_thresh=10.0)
    seq = cls[1]((StereoCamera if stereo else RGBDCamera)(**cam), pyrlevels=3, keyframe_trans_thresh=10.0,
                 device="cpu")
    for p in (ref, out, seq):
        p.track(*first, **kw)
    got = out.track_batch([f[0] for f in frames[1:]])
    ref.track_batch([f[0] for f in frames[1:]])
    for f in frames[1:]:
        seq.track(f[0], f[1])
    assert len(got) == 4 and all(g.mat.shape == (4, 4) for g in got)
    _hold(np.stack(out.T_c_w), np.stack(ref.T_c_w))
    _hold(np.stack(out.T_c_w), np.stack(seq.T_c_w), tol=1e-3)  # extrapolated, not chained, guesses
    np.testing.assert_allclose(np.stack(out.T_c_w)[:, :3, 3], -np.stack(steps), atol=4e-3)


def test_track_batch_requires_keyframe():
    pipe = DenseRGBDPipeline(RGBDCamera(**PLANE_CAM), pyrlevels=2, device="cpu")
    with pytest.raises(RuntimeError, match="keyframe"):
        pipe.track_batch([render_rgbd(np.zeros(3))[0]])


def test_affine_tracking_through_exposure_changes_matches_reference():
    """``tests/test_pipelines.py``'s exposure changes: a random gain and
    bias a frame, absorbed by the affine kernel. The eliminated gain and
    bias weaken the pose's conditioning: here the reference's float32
    trajectory lies 9.9e-5 from the port's float64 one (the port's float32
    2.5e-5 from its float64), so the two float32 runs are held to 2.5e-4."""
    rng = np.random.default_rng(0)
    ref, out = _pair(JaxRGBDPipeline, DenseRGBDPipeline, PLANE_CAM, pyrlevels=3, affine_illumination=True,
                     keyframe_trans_thresh=10.0)
    traj = [np.array([0.02 * k, -0.01 * k, 0.015 * k]) for k in range(4)]
    for t in traj:
        im, depth = render_rgbd(t)
        im = np.clip((1.0 + 0.25 * rng.standard_normal()) * im + 0.1 * rng.standard_normal(), 0.0, 2.0)
        ref.track(im, depth)
        out.track(im, depth)
    _hold(np.stack(out.T_c_w), np.stack(ref.T_c_w), tol=2.5e-4)
    np.testing.assert_allclose(np.stack(out.T_c_w)[:, :3, 3], -np.stack(traj), atol=5e-3)


def test_pipelines_build_on_the_named_device():
    pipe = DenseRGBDPipeline(RGBDCamera(**PLANE_CAM), pyrlevels=2, device="cpu")
    pipe.track(*render_rgbd(np.zeros(3)))
    assert pipe.device.type == "cpu" and all(lv.pt_ref.device.type == "cpu" for lv in pipe.keyframes[0].levels)


# ---- the port's copies of the synthetic frames ----


def test_vo_frames_are_the_benchmarks():
    sys.path.insert(0, os.path.join(ROOT, "bench"))
    from vo_overlap import CAM, make_frames

    assert testing.VO_CAM == CAM
    for (im, depth), (im_r, depth_r) in zip(testing.vo_frames(3), make_frames(3)):
        assert im.dtype == im_r.dtype == np.uint8
        np.testing.assert_array_equal(im, im_r)
        np.testing.assert_array_equal(depth, depth_r)


def test_plane_frames_are_the_tests():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_pipelines as ref

    assert testing.PLANE_CAM == ref.CAM
    t = np.array([0.03, -0.02, 0.01])
    for out, exp in zip(render_rgbd(t), ref.render_rgbd(t)):
        np.testing.assert_array_equal(out, exp)
    for out, exp in zip(render_stereo(t, b=0.4), ref.render_stereo(t, b=0.4)):
        np.testing.assert_array_equal(out, exp)
    # at VGA: the reference's scene with the benchmark's intrinsics
    im, depth = render_rgbd(t, testing.VO_CAM)
    assert im.shape == depth.shape == (480, 640)


def test_stereo_vga_frames_carry_the_matcher_tests_texture():
    """``vo_stereo_frames``' texture is the one the reference's
    ``test_stereo_pipeline_with_tpu_matcher`` builds (its lines at its own
    size); the frames are the benchmark's uint8 quantization of the plane
    along ``vo_frames``' path, the first pixel column of the camera at the
    origin on the texture's columns."""
    rng = np.random.default_rng(1)
    H, W, pad = 96, 192, 64
    tex = rng.uniform(0.2, 0.8, (H, W + 2 * pad))
    k = np.ones(3) / 3
    tex = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, tex)
    np.testing.assert_array_equal(testing.matcher_texture((H, W + 2 * pad)), tex)

    frames = testing.vo_stereo_frames(2)
    big = testing.matcher_texture((480 + 2 * testing.VO_STEREO_PAD, 640 + 2 * testing.VO_STEREO_PAD))
    left, right, disp = frames[0]
    assert left.dtype == right.dtype == np.uint8 and left.shape == right.shape == disp.shape == (480, 640)
    # the camera at the origin sees the texture at half-texel offsets of
    # its principal point (319.5, 239.5): whole texels
    p = testing.VO_STEREO_PAD
    np.testing.assert_array_equal(left, (np.clip(big[p: p + 480, p: p + 640], 0, 1) * 255).astype(np.uint8))
    np.testing.assert_allclose(disp, 525.0 * 0.3 / 4.0)
    assert not np.array_equal(frames[1][0], left)
