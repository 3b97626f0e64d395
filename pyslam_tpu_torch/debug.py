"""Debug and validation utilities: NaN / Inf propagation and shape or index
faults, the hazards of a batched solver.

Counterpart of ``pyslam_tpu/debug.py``:

  * ``nan_debug()``      — a context manager in which every op whose output
    holds a NaN raises ``FloatingPointError`` naming the op (the reference
    flips ``jax_debug_nans``).  It checks each output of each op, a host
    read per op: for debugging only.
  * ``validate_graph``   — host-side structural lint of a FactorGraph:
    index ranges, shape agreement, weight and mask sanity, finite values.
    Returns a list of readable problems (empty = clean).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

# Whether the innermost nan_debug block checks; an enabled block that
# holds a nan_debug(False) block pauses for its length.
_CHECKING = [False]


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _CHECKING[-1]:
            for t in _pytree.tree_leaves(out):
                if torch.is_tensor(t) and (t.is_floating_point() or t.is_complex()) and bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"nan_debug: {func} produced a NaN (output shape {tuple(t.shape)})")
        return out


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    """Inside the block, raise at the first op whose output holds a NaN
    (``enable``), or stop checking (``enable=False`` inside an enabled
    block).  The state before the block is restored on exit."""
    _CHECKING.append(bool(enable))
    try:
        if enable:
            with _NanCheck():
                yield
        else:
            yield
    finally:
        _CHECKING.pop()


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def validate_graph(graph) -> list[str]:
    """Structural lint for a FactorGraph; returns a list of problems."""
    problems: list[str] = []
    from .graph.core import FACTOR_KERNELS, MANIFOLDS

    for name, b in graph.blocks.items():
        vals = _np(b.values)
        if b.kind != "euclidean" and b.kind not in MANIFOLDS:
            problems.append(f"block {name!r}: unknown manifold kind {b.kind!r}")
            continue
        if b.kind != "euclidean":
            want = MANIFOLDS[b.kind]["shape"]
            if vals.shape[1:] != want:
                problems.append(f"block {name!r}: element shape {vals.shape[1:]} != {want} for {b.kind}")
        if not np.isfinite(vals).all():
            problems.append(f"block {name!r}: non-finite values")
        cm = _np(b.const_mask)
        if cm.shape != (vals.shape[0],) or cm.dtype != np.bool_:
            problems.append(f"block {name!r}: const_mask shape/dtype mismatch")

    for bi, fb in enumerate(graph.batches):
        tag = f"batch {bi} ({fb.kind!r})"
        if fb.kind not in FACTOR_KERNELS:
            problems.append(f"{tag}: unregistered factor kind")
        if len(fb.slots) != len(fb.indices):
            problems.append(f"{tag}: {len(fb.slots)} slots vs {len(fb.indices)} index arrays")
            continue
        n = fb.n
        for slot, idx in zip(fb.slots, fb.indices):
            if slot not in graph.blocks:
                problems.append(f"{tag}: slot {slot!r} is not a variable block")
                continue
            iv = _np(idx)
            if iv.shape != (n,):
                problems.append(f"{tag}: index array for slot {slot!r} has shape {iv.shape}, want ({n},)")
            nb = graph.blocks[slot].n
            if iv.size and (iv.min() < 0 or iv.max() >= nb):
                problems.append(
                    f"{tag}: indices for slot {slot!r} out of range [0, {nb}) "
                    f"(min {iv.min()}, max {iv.max()})"
                )
        w = _np(fb.weight)
        if w.shape != (n,):
            problems.append(f"{tag}: weight shape {w.shape}, want ({n},)")
        elif not np.isfinite(w).all() or (w < 0).any():
            problems.append(f"{tag}: weights must be finite and >= 0")
        for k, v in fb.data.items():
            if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == n and not np.isfinite(_np(v)).all():
                problems.append(f"{tag}: data[{k!r}] has non-finite entries")
    return problems


def assert_graph_valid(graph) -> None:
    problems = validate_graph(graph)
    if problems:
        raise ValueError("invalid FactorGraph:\n  " + "\n  ".join(problems))


__all__ = ["nan_debug", "validate_graph", "assert_graph_valid"]
