"""Linearization of factor batches with fused IRLS weights.

Counterpart of ``pyslam_tpu/solver/assemble.py``.  Ported so far:
``linearize_batch`` and ``free_mask``; the dense assembly comes with a
later slice of the port.
"""

from __future__ import annotations

import torch

from ..graph.core import FactorGraph


def linearize_batch(fb, blocks):
    """Evaluate one factor batch: residuals, Jacobians, fused IRLS weights,
    and its robustified cost contribution."""
    r, jacs = fb.evaluate(blocks, compute_jacobians=True)
    # A kernel's per-slot Jacobian width must equal the slot's manifold dof;
    # otherwise its columns would land in the wrong tangent entries and the
    # solve would converge to silent garbage.
    for s, (slot, J) in enumerate(zip(fb.slots, jacs)):
        dof = blocks[slot].dof
        if J.shape[-1] != dof:
            raise ValueError(
                f"factor kind {fb.kind!r} slot {s} ({slot!r}): Jacobian "
                f"width {J.shape[-1]} != block dof {dof} (kind "
                f"{blocks[slot].kind!r}).  A Lie-group parameter passed as "
                f"a raw array is inferred 'euclidean' — wrap it in the "
                f"matching group type (SE2/SE3/Sim3/...)"
            )
    w = fb.loss.weight(r) * fb.weight[:, None]
    chi2 = torch.sum(fb.loss.loss(r) * fb.weight[:, None])
    return r, jacs, w, chi2


def free_mask(graph: FactorGraph) -> torch.Tensor:
    """(D,) bool — False where the variable element is held constant."""
    segs = [torch.repeat_interleave(~b.const_mask, b.dof) for b in graph.blocks.values()]
    return torch.cat(segs)
