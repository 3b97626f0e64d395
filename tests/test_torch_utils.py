"""The twin of ``tests/test_utils.py``: the reference's own inputs through
the port's ``utils`` and the JAX package's, in f64 on the CPU, at the
reference test's tolerances.

Held here: ``TestBilinearInterpolate::test_exact_at_integer_coords``,
``::test_linear_surface_is_exact``, ``TestKahanSum::test_empty_and_small``.

Held by ``tests/test_torch_tools.py``:
  * ``TestInvsqrt::test_scalar``, ``::test_spd_matrix``, ``::test_batched``
    and ``TestStackmul::test_matches_numpy``:
    ``test_torch_tools.py::test_invsqrt_and_stackmul_match_reference``
    (a batch of SPD matrices within 1e-10 of the reference, W S Wᵀ = I,
    the scalar 4 -> 0.5, the stacked product);
  * ``TestBilinearInterpolate::test_gradients_match_autodiff``:
    ``test_torch_tools.py::test_bilinear_gradients_match_autograd``;
  * ``TestBilinearInterpolate::test_multichannel``:
    ``test_torch_tools.py::test_bilinear_interpolate_matches_reference``
    (one and three channels);
  * ``TestKahanSum::test_matches_f64_on_adversarial_f32``:
    ``test_torch_tools.py::test_kahan_sum_matches_reference`` (the same
    200,000 f32 values, the reference's bits).
"""

import jax.numpy as jnp
import numpy as np
import torch

from pyslam_tpu import utils as jutils
from pyslam_tpu_torch import utils
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)


def _both(im, u, v, **kw):
    out = utils.bilinear_interpolate(torch.tensor(im), torch.tensor(u), torch.tensor(v), **kw)
    ref = jutils.bilinear_interpolate(jnp.asarray(im), jnp.asarray(u), jnp.asarray(v), **kw)
    return out, ref


def test_exact_at_integer_coords():
    im = np.random.default_rng(0).normal(size=(8, 10))
    u, v = np.array([0.0, 3.0, 8.0]), np.array([0.0, 2.0, 6.0])
    out, ref = _both(im, u, v)
    expect = im[v.astype(int), u.astype(int)]
    np.testing.assert_allclose(out.numpy(), expect, atol=1e-12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_linear_surface_is_exact():
    """On a linear ramp interpolation is exact everywhere, and the analytic
    gradients are the ramp's slopes."""
    vv, uu = np.meshgrid(np.arange(12), np.arange(16), indexing="ij")
    im = 2.0 * uu + 3.0 * vv + 1.0
    u, v = np.array([1.25, 7.5, 14.9]), np.array([0.5, 3.75, 10.2])
    out, ref = _both(im, u, v, compute_gradients=True)
    vals, gu, gv = (t.numpy() for t in out)
    np.testing.assert_allclose(vals, 2.0 * u + 3.0 * v + 1.0, atol=1e-9)
    np.testing.assert_allclose(gu, 2.0, atol=1e-9)
    np.testing.assert_allclose(gv, 3.0, atol=1e-9)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_kahan_sum_empty_and_small():
    assert float(utils.kahan_sum(torch.zeros(0, dtype=torch.float32))) == 0.0
    assert float(jutils.kahan_sum(jnp.zeros(0, jnp.float32))) == 0.0
    x = np.array([1.5, 2.5])
    assert float(utils.kahan_sum(torch.tensor(x))) == float(jutils.kahan_sum(jnp.asarray(x))) == 4.0
