"""Factor-graph core: variables and factors as struct-of-arrays batches.

Counterpart of ``pyslam_tpu/graph/core.py`` on torch tensors:

* ``VariableBlock`` — N manifold elements of one kind stored contiguously
  (all SE(3) poses as one (N, 4, 4) tensor) with a per-element constant
  mask.
* ``FactorBatch``   — F factors of one kind: per-slot index tensors into
  the variable blocks, a dict of measurement tensors, a robust loss and a
  per-factor weight (0 for padding).
* ``FactorGraph``   — blocks in sorted name order + batches; knows the
  global tangent layout and provides chi2 / retract.

All three are frozen dataclasses; an update builds a new graph.  Every
tensor of a graph lives on one device, the one its builder was given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..lie import se3

# --------------------------------------------------------------------------
# Manifolds
# --------------------------------------------------------------------------

# Only SE(3) is ported so far; any other kind raises KeyError.
MANIFOLDS: dict[str, dict[str, Any]] = {
    "se3": dict(dof=6, retract=lambda T, dx: se3.perturb(T, dx), shape=(4, 4)),
}


def manifold_dof(kind: str, element_shape=None) -> int:
    return MANIFOLDS[kind]["dof"]


def retract(kind: str, values, dx):
    """Batched manifold update with the left-multiplicative convention
    exp(dx) * T."""
    return MANIFOLDS[kind]["retract"](values, dx)


# --------------------------------------------------------------------------
# Variable blocks
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VariableBlock:
    """N manifold elements stored contiguously.

    kind:       'se3'
    values:     (N, *element_shape)
    const_mask: (N,) bool — True freezes the element (zero update)
    """

    kind: str
    values: torch.Tensor
    const_mask: torch.Tensor

    @classmethod
    def create(cls, kind: str, values: torch.Tensor, const_mask=None):
        if const_mask is None:
            const_mask = torch.zeros(values.shape[0], dtype=torch.bool, device=values.device)
        else:
            const_mask = torch.as_tensor(const_mask, dtype=torch.bool, device=values.device)
        return cls(kind, values, const_mask)

    @property
    def n(self) -> int:
        return self.values.shape[0]

    @property
    def dof(self) -> int:
        return manifold_dof(self.kind, self.values.shape[1:])


# --------------------------------------------------------------------------
# Factor batches
# --------------------------------------------------------------------------

# kind -> fn(data: dict, *vals, compute_jacobians) -> (r (F, m), jacs tuple[(F, m, dof_slot)])
FACTOR_KERNELS: dict[str, Callable] = {}


def register_factor(kind: str):
    def deco(fn):
        FACTOR_KERNELS[kind] = fn
        return fn

    return deco


@dataclasses.dataclass(frozen=True)
class FactorBatch:
    """F factors of one kind over the same variable-slot pattern.

    kind:    registered kernel name
    slots:   variable-block names, one per parameter slot
    indices: per-slot (F,) int64 tensors into the blocks
    data:    measurement tensors, each (F, ...)
    loss:    robust M-estimator, applied elementwise
    weight:  (F,) float — 1 for live factors, 0 for padding
    """

    kind: str
    slots: tuple
    indices: tuple
    data: dict
    loss: Any
    weight: torch.Tensor

    @classmethod
    def create(cls, kind, slots, indices, data, loss, weight=None):
        """``weight`` defaults to ones in the dtype and on the device of the
        measurement tensors in ``data``."""
        ref = next(v for v in data.values() if torch.is_floating_point(v))
        indices = tuple(
            torch.tensor(np.asarray(i, dtype=np.int64), device=ref.device) for i in indices
        )
        if weight is None:
            weight = torch.ones(indices[0].shape[0], dtype=ref.dtype, device=ref.device)
        else:
            weight = torch.as_tensor(weight, dtype=ref.dtype, device=ref.device)
        return cls(kind, tuple(slots), indices, dict(data), loss, weight)

    @property
    def n(self) -> int:
        return self.indices[0].shape[0]

    def evaluate(self, blocks: dict, compute_jacobians: bool = True):
        """Gather slot values and run the batched residual kernel."""
        vals = [blocks[name].values[idx] for name, idx in zip(self.slots, self.indices)]
        return FACTOR_KERNELS[self.kind](self.data, *vals, compute_jacobians=compute_jacobians)


# --------------------------------------------------------------------------
# Factor graph
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FactorGraph:
    """Ordered variable blocks + factor batches, with the global tangent
    layout."""

    blocks: dict  # name -> VariableBlock (SORTED name order = tangent order)
    batches: list  # FactorBatch

    def __post_init__(self):
        # Sorted-by-name block order, as in the reference, so the tangent
        # layout of both packages is the same.
        names = list(self.blocks)
        if names != sorted(names):
            object.__setattr__(self, "blocks", {k: self.blocks[k] for k in sorted(names)})

    # ---- layout ----
    def offsets(self) -> dict:
        off, cur = {}, 0
        for name, b in self.blocks.items():
            off[name] = cur
            cur += b.n * b.dof
        return off

    @property
    def total_dof(self) -> int:
        return sum(b.n * b.dof for b in self.blocks.values())

    # ---- evaluation ----
    def chi2(self) -> torch.Tensor:
        """Robustified total cost: sum of loss.loss over all (weighted)
        residual elements."""
        total = 0.0
        for fb in self.batches:
            r, _ = fb.evaluate(self.blocks, compute_jacobians=False)
            total = total + torch.sum(fb.loss.loss(r) * fb.weight[:, None])
        return total

    def retract_all(self, dx: torch.Tensor) -> "FactorGraph":
        """Apply a global tangent update, respecting constant masks."""
        new_blocks = {}
        cur = 0
        for name, b in self.blocks.items():
            d = b.dof
            seg = dx[cur : cur + b.n * d].reshape(b.n, d)
            seg = torch.where(b.const_mask[:, None], 0.0, seg)
            new_blocks[name] = VariableBlock(b.kind, retract(b.kind, b.values, seg), b.const_mask)
            cur += b.n * d
        return FactorGraph(new_blocks, self.batches)

    def with_values(self, blocks: dict) -> "FactorGraph":
        return FactorGraph(blocks, self.batches)
