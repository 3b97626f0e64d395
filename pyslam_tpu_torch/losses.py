"""Robust M-estimator losses on torch tensors: counterpart of
``pyslam_tpu/losses.py`` (``L2Loss``, ``L1Loss``, ``CauchyLoss``,
``HuberLoss``, ``TukeyLoss``, ``TDistributionLoss``).

Each loss is a rho/psi/weight triple applied elementwise to the stacked
residual vector:

  * ``loss(e)``      — the robustified cost contribution rho(e)
  * ``influence(e)`` — psi(e) = d rho / d e
  * ``weight(e)``    — the IRLS weight psi(e) / e
"""

from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class L2Loss:
    """Standard squared loss: rho = e^2 / 2, unit IRLS weights."""

    def loss(self, e):
        return 0.5 * torch.square(e)

    def influence(self, e):
        return e

    def weight(self, e):
        return torch.ones_like(e)


@dataclasses.dataclass(frozen=True)
class L1Loss:
    """Absolute loss: rho = |e|, weight = 1/|e| (guarded at 0)."""

    def loss(self, e):
        return torch.abs(e)

    def influence(self, e):
        return torch.sign(e)

    def weight(self, e):
        return 1.0 / torch.clamp(torch.abs(e), min=_EPS)


@dataclasses.dataclass(frozen=True)
class CauchyLoss:
    """Cauchy/Lorentzian: rho = (k^2/2) log(1 + (e/k)^2)."""

    k: float = 1.0

    def loss(self, e):
        return 0.5 * self.k**2 * torch.log1p(torch.square(e / self.k))

    def influence(self, e):
        return e / (1.0 + torch.square(e / self.k))

    def weight(self, e):
        return 1.0 / (1.0 + torch.square(e / self.k))


@dataclasses.dataclass(frozen=True)
class HuberLoss:
    """Huber: quadratic inside |e| <= k, linear outside."""

    k: float = 1.0

    def loss(self, e):
        abs_e = torch.abs(e)
        return torch.where(abs_e <= self.k, 0.5 * e * e, self.k * (abs_e - 0.5 * self.k))

    def influence(self, e):
        return torch.clamp(e, -self.k, self.k)

    def weight(self, e):
        return torch.clamp(self.k / torch.clamp(torch.abs(e), min=_EPS), max=1.0)


@dataclasses.dataclass(frozen=True)
class TukeyLoss:
    """Tukey biweight: hard redescending — zero influence beyond k."""

    k: float = 4.6851

    def loss(self, e):
        k2_6 = self.k**2 / 6.0
        inside = k2_6 * (1.0 - (1.0 - torch.square(e / self.k)) ** 3)
        return torch.where(torch.abs(e) <= self.k, inside, k2_6)

    def influence(self, e):
        return e * self.weight(e)

    def weight(self, e):
        r = torch.square(e / self.k)
        return torch.where(torch.abs(e) <= self.k, torch.square(1.0 - r), 0.0)


@dataclasses.dataclass(frozen=True)
class TDistributionLoss:
    """Student-t loss (Kerl et al. DVO).

    ``weight(e) = (nu + 1) / (nu + (e/scale)^2)``.  If ``scale`` is None the
    scale is re-estimated from the residuals by ten fixed-point iterations
    each call, as in the reference.
    """

    nu: float = 5.0
    scale: float | None = None

    def _estimate_scale(self, e):
        nu = self.nu
        sigma2 = torch.mean(torch.square(e)) + _EPS
        for _ in range(10):
            w = (nu + 1.0) / (nu + torch.square(e) / sigma2)
            sigma2 = torch.mean(w * torch.square(e)) + _EPS
        return sigma2

    def _sigma2(self, e):
        if self.scale is not None:
            return torch.tensor(self.scale, dtype=e.dtype, device=e.device) ** 2
        return self._estimate_scale(e)

    def loss(self, e):
        s2 = self._sigma2(e)
        return 0.5 * (self.nu + 1.0) * torch.log1p(torch.square(e) / (self.nu * s2))

    def influence(self, e):
        return e * self.weight(e)

    def weight(self, e):
        s2 = self._sigma2(e)
        return (self.nu + 1.0) / (self.nu + torch.square(e) / s2)


__all__ = [
    "L2Loss",
    "L1Loss",
    "CauchyLoss",
    "HuberLoss",
    "TukeyLoss",
    "TDistributionLoss",
]
