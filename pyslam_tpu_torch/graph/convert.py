"""Build a port graph from the arrays of a reference graph.

``graph_from_numpy`` takes a factor graph as plain numpy arrays (values,
constant masks, indices, measurement dicts, weights and the loss) and
builds the same problem as a torch ``FactorGraph``.  With it both
packages solve exactly the same problem.  The caller does the
``np.asarray`` calls; this module needs nothing but numpy and torch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import losses
from .core import FactorBatch, FactorGraph, VariableBlock


def graph_from_numpy(blocks: dict, batches: list, dtype, device="cpu") -> FactorGraph:
    """``blocks``: name -> dict(kind, values, const_mask).
    ``batches``: list of dict(kind, slots, indices, data, weight, loss),
    where ``loss`` is ``(class name, {field: value})``, for example
    ``("CauchyLoss", {"k": 2.0})``.  Floating arrays become ``dtype``."""

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    t_blocks = {
        name: VariableBlock.create(
            b["kind"],
            tensor(b["values"]),
            torch.tensor(np.asarray(b["const_mask"], bool), device=device),
        )
        for name, b in blocks.items()
    }
    t_batches = []
    for fb in batches:
        loss_name, loss_fields = fb["loss"]
        if loss_name not in losses.__all__:
            raise ValueError(f"unknown loss {loss_name!r}")
        t_batches.append(
            FactorBatch.create(
                kind=fb["kind"],
                slots=fb["slots"],
                indices=[np.asarray(i) for i in fb["indices"]],
                data={k: tensor(v) for k, v in fb["data"].items()},
                loss=getattr(losses, loss_name)(**loss_fields),
                weight=tensor(fb["weight"]),
            )
        )
    return FactorGraph(t_blocks, t_batches)
