"""The six robust losses of the torch port against the JAX reference, in
f64 on the same numpy residuals: ``loss``, ``weight`` and ``influence``,
absolute tolerance 1e-12."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu import losses as jl
from pyslam_tpu_torch import losses as tl
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

LOSSES = [
    ("L2Loss", {}),
    ("L1Loss", {}),
    ("CauchyLoss", {"k": 2.0}),
    ("HuberLoss", {"k": 1.5}),
    ("TukeyLoss", {}),
    ("TDistributionLoss", {}),
    ("TDistributionLoss", {"scale": 2.0}),
]


def _residuals():
    rng = np.random.default_rng(7)
    e = rng.normal(0.0, 3.0, size=(50, 6))
    e[0, :3] = [0.0, 1.5, -4.6851]  # zero, Huber's k, Tukey's k
    return e


@pytest.mark.parametrize("method", ["loss", "weight", "influence"])
@pytest.mark.parametrize("name,fields", LOSSES, ids=[f"{n}{f}" for n, f in LOSSES])
def test_loss_matches_reference(name, fields, method):
    e = _residuals()
    ref = getattr(getattr(jl, name)(**fields), method)(jnp.asarray(e))
    out = getattr(getattr(tl, name)(**fields), method)(torch.from_numpy(e))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", tl.__all__)
def test_same_fields_as_reference(name):
    """Each loss has the reference's fields and defaults, so a loss spec
    read off a JAX graph builds the same loss here."""
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jl, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tl, name))}
    assert jf == tf
