"""The port's plane-sweep block matcher against the JAX reference on the
same numpy pairs: the same NaN mask and disparities within 1e-4 (in fact
the same bits: the integral images add in the reference's CPU order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.pipelines.keyframes import compute_disparity as jax_compute_disparity
from pyslam_tpu.pipelines.stereo_match import block_match as jax_block_match
from pyslam_tpu_torch.pipelines.keyframes import compute_disparity
from pyslam_tpu_torch.pipelines.stereo_match import _cumsum, block_match
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)


def _pair(H, W, d_true, seed, noise=0.0, smooth=3):
    """A textured rectified pair at constant disparity d_true."""
    rng = np.random.default_rng(seed)
    pad = 64
    tex = rng.uniform(0, 1, (H, W + 2 * pad))
    tex = np.apply_along_axis(lambda r: np.convolve(r, np.ones(smooth) / smooth, mode="same"), 1, tex)
    left = tex[:, pad: pad + W]
    right = tex[:, pad + d_true: pad + d_true + W] + noise * rng.standard_normal((H, W))
    return left, right


def _same(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    m = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out), m)
    np.testing.assert_allclose(out[m], ref[m], rtol=0, atol=1e-4)
    return m


@pytest.mark.parametrize("n", [1, 7, 16, 17, 48, 300])
@pytest.mark.parametrize("axis", [0, 1])
def test_prefix_sum_in_the_reference_order(n, axis):
    x = np.random.default_rng(n).uniform(0, 1, (n, 5) if axis == 0 else (5, n)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=axis))(x))
    np.testing.assert_array_equal(_cumsum(torch.from_numpy(x), axis).numpy(), ref)


CASES = [
    dict(shape=(48, 64), d=13, D=16, kw={}),
    dict(shape=(96, 192), d=23, D=48, kw={}),
    dict(shape=(60, 100), d=9, D=32, kw=dict(block_radius=3, uniqueness_ratio=1.3, texture_threshold=0.2), noise=0.02),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_block_match_matches_reference(case):
    c = CASES[case]
    left, right = _pair(*c["shape"], c["d"], seed=case, noise=c.get("noise", 0.01))
    ref = jax_block_match(left, right, num_disparities=c["D"], **c["kw"])
    out = block_match(left, right, num_disparities=c["D"], device="cpu", **c["kw"])
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    m = _same(out, ref)
    assert 0.2 < m.mean() < 1.0
    np.testing.assert_array_equal(out.numpy()[m], np.asarray(ref)[m])


@pytest.mark.parametrize("chunk", [1, 5, 32])
def test_chunking_does_not_change_the_result(monkeypatch, chunk):
    """The hypotheses costed at once, one at a time (the reference's sweep)
    or more: the same bits."""
    from pyslam_tpu_torch.pipelines import stereo_match

    left, right = _pair(40, 90, 11, seed=5, noise=0.02)
    base = block_match(left, right, num_disparities=32, device="cpu").numpy()
    monkeypatch.setattr(stereo_match, "_CHUNK", chunk)
    np.testing.assert_array_equal(block_match(left, right, num_disparities=32, device="cpu").numpy(), base)


@pytest.mark.parametrize("as_uint8", [False, True])
def test_compute_disparity_tpu_matcher(as_uint8):
    """``matcher="tpu"`` (the reference's name) runs the port's matcher on the
    given device, with the reference's default disparity count and uint8
    normalization, and returns float64 on the host."""
    left, right = _pair(96, 192, 17, seed=3)
    if as_uint8:
        left, right = (np.clip(im * 255.0, 0, 255).astype(np.uint8) for im in (left, right))
    ref = jax_compute_disparity(left, right, matcher="tpu")
    out = compute_disparity(left, right, matcher="tpu", device="cpu")
    assert out.dtype == np.float64
    m = _same(out, ref)
    assert np.median(np.abs(out[m] - 17)) < 0.05


def test_opencv_matchers_follow_the_reference():
    pytest.importorskip("cv2")
    left, right = _pair(96, 256, 17, seed=3)
    for matcher in ("sgbm", "bm"):
        np.testing.assert_array_equal(compute_disparity(left, right, matcher=matcher, num_disparities=48),
                                      jax_compute_disparity(left, right, matcher=matcher, num_disparities=48))


def test_opencv_matcher_without_opencv_raises(monkeypatch):
    """Where OpenCV is missing (the card's machine) "sgbm" raises; no other
    matcher stands in."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    left, right = _pair(48, 64, 5, seed=0)
    with pytest.raises(ImportError):
        compute_disparity(left, right, matcher="sgbm")
