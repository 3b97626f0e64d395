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

``register_factor`` adds a kernel with analytic Jacobians;
``register_autodiff_factor`` one whose Jacobians come from
``torch.func.jacfwd`` (``check_autodiff_factor`` tests its contract), and
``register_closed_kernel`` one that closes over data without the factor
axis, named by the content of that data.

All three are frozen dataclasses; an update builds a new graph.  Every
tensor of a graph lives on one device, the one its builder was given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..lie import se2, se3, sim3, so2, so3

# --------------------------------------------------------------------------
# Manifolds
# --------------------------------------------------------------------------

_EUCLIDEAN = "euclidean"

# The Lie kinds and the BAL camera.  'euclidean' is handled outside this
# table, with its dof taken from the element shape.
MANIFOLDS: dict[str, dict[str, Any]] = {
    "se3": dict(dof=6, retract=lambda T, dx: se3.perturb(T, dx), shape=(4, 4)),
    "se2": dict(dof=3, retract=lambda T, dx: se2.perturb(T, dx), shape=(3, 3)),
    "so3": dict(dof=3, retract=lambda R, dx: so3.perturb(R, dx), shape=(3, 3)),
    "so2": dict(dof=1, retract=lambda R, dx: so2.perturb(R, dx[..., 0]), shape=(2, 2)),
    "sim3": dict(dof=7, retract=lambda S, dx: sim3.perturb(S, dx), shape=(4, 4)),
}


def _retract_bal_cam9(v, dx):
    """Product manifold SE(3) x R^3 of the full BAL camera (pose and the
    intrinsics [f, k1, k2]), stored flat as (..., 19) = [vec(T) (16), f, k1,
    k2].  Pose and intrinsics in ONE 9-dof block keep the two-block
    camera/landmark structure that the Schur path assumes."""
    T = se3.perturb(v[..., :16].reshape(v.shape[:-1] + (4, 4)), dx[..., :6])
    return torch.cat([T.reshape(v.shape[:-1] + (16,)), v[..., 16:] + dx[..., 6:]], dim=-1)


MANIFOLDS["bal_cam9"] = dict(dof=9, retract=_retract_bal_cam9, shape=(19,))


def manifold_dof(kind: str, element_shape=None) -> int:
    if kind == _EUCLIDEAN:
        return int(np.prod(element_shape, dtype=np.int64))
    return MANIFOLDS[kind]["dof"]


def retract(kind: str, values, dx):
    """Batched manifold update: Lie kinds use the left-multiplicative
    convention exp(dx) * T, 'euclidean' adds."""
    if kind == _EUCLIDEAN:
        return values + dx.reshape(values.shape)
    return MANIFOLDS[kind]["retract"](values, dx)


# --------------------------------------------------------------------------
# Variable blocks
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VariableBlock:
    """N manifold elements stored contiguously.

    kind:       'se3' | 'se2' | 'so3' | 'so2' | 'sim3' | 'bal_cam9' | 'euclidean'
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


def register_autodiff_factor(kind: str, residual_fn: Callable, manifolds: tuple):
    """Register a factor kind whose Jacobians come from automatic
    differentiation (Ceres' AutoDiffCostFunction): a new factor type is
    written as its batched residual alone.

    ``residual_fn(data, *vals) -> (F, m)`` evaluates the residual batch;
    ``manifolds`` names each slot's kind ('se3', 'sim3', 'euclidean', ...).
    The Jacobians are taken with ``torch.func.jacfwd`` with respect to the
    same retraction the solver applies (``retract``), so autodiff and
    analytic factors are interchangeable on every solver path.  One shared
    eps perturbs every row of a slot at once: each factor's residual
    depends only on its own row, so the forward Jacobian of the (F, m)
    residual in the (dof,) eps is exactly the (F, m, dof) per-factor
    blocks, with no vmap over the factors.

    RESTRICTION: row f of the residual must depend only on row f of each
    slot.  A residual that couples rows (normalizing by a batch statistic
    such as ``r / r.std()``) folds every other row's derivative into each
    block; ``check_autodiff_factor`` tests the contract on concrete data.
    ``residual_fn`` must be a function of tensors that ``torch.func``
    can transform: no ``.item()``, no in-place write into an input."""

    def kernel(data, *vals, compute_jacobians=True):
        r = residual_fn(data, *vals)
        if not compute_jacobians:
            return r, None
        jacs = []
        for i, kind_i in enumerate(manifolds):
            dof = manifold_dof(kind_i, vals[i].shape[1:])

            def f(eps, i=i, kind_i=kind_i, dof=dof):
                vs = list(vals)
                vs[i] = retract(kind_i, vs[i], eps.expand(vs[i].shape[0], dof))
                return residual_fn(data, *vs)

            jacs.append(torch.func.jacfwd(f)(vals[i].new_zeros(dof)))
        return r, tuple(jacs)

    FACTOR_KERNELS[kind] = kernel
    return kernel


def check_autodiff_factor(kind: str, data: dict, *vals, atol: float = 1e-6):
    """Test the row-independence contract of a registered factor on
    concrete data: perturbing only row 0 of a slot must change only row 0
    of the residual.  Raises ValueError on cross-row coupling, which makes
    ``register_autodiff_factor``'s shared-eps Jacobians wrong."""
    kernel = FACTOR_KERNELS[kind]
    r0, _ = kernel(data, *vals, compute_jacobians=False)
    for i, v in enumerate(vals):
        eps = 1e-4 * (1.0 + torch.arange(v[0].numel(), dtype=r0.dtype, device=v.device)).reshape(v.shape[1:])
        v_pert = v.clone()
        v_pert[0] = v[0] + eps.to(v.dtype)
        vs = list(vals)
        vs[i] = v_pert
        r1, _ = kernel(data, *vs, compute_jacobians=False)
        other = (r1[1:] - r0[1:]).abs().max().item() if r0.shape[0] > 1 else 0.0
        if other > atol:
            raise ValueError(
                f"factor {kind!r} slot {i}: residual rows are coupled "
                f"(perturbing row 0 moved other rows by {other:.2e}) — "
                "register_autodiff_factor's Jacobians are invalid for it"
            )


def register_closed_kernel(kind: str, static_data: dict) -> str:
    """Register (or reuse) a kernel of ``kind`` that closes over data
    without the factor axis (an unbatched camera, say) and return its
    registry name.

    The name is a content hash of ``static_data``
    (``solver.plan_cache.content_key``: the structure, and each array's or
    tensor's dtype, shape and bytes), never ``id()``: a recycled id with
    other data would reuse stale constants, and id-keyed entries would grow
    the registry with every call.  Equal content shares one entry; distinct
    content gets its own."""
    from ..solver.plan_cache import content_key

    kname = f"__closed_{kind}_{content_key((kind, static_data))}"
    if kname not in FACTOR_KERNELS:
        base = dict(static_data)

        def kernel(data, *vals, compute_jacobians=True):
            return FACTOR_KERNELS[kind]({**data, **base}, *vals, compute_jacobians=compute_jacobians)

        FACTOR_KERNELS[kname] = kernel
    return kname


@dataclasses.dataclass(frozen=True)
class FactorBatch:
    """F factors of one kind over the same variable-slot pattern.

    kind:    registered kernel name
    slots:   variable-block names, one per parameter slot
    indices: per-slot (F,) int64 tensors into the blocks
    data:    what the kernel reads beside the variables: measurement tensors
             (F, ...); a tensor without the factor axis where the kernel
             broadcasts it (one ``sqrt_info`` (m, m) for the whole batch);
             and values that are no tensors (``camera``: a ``sensors``
             camera).  Nothing slices ``data`` by factor: a batch is
             evaluated whole.
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
        floating-point tensors in ``data``."""
        ref = next(v for v in data.values() if torch.is_tensor(v) and v.is_floating_point())
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
