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

from .. import losses, sensors
from .._device import resolve_device
from .core import FactorBatch, FactorGraph, VariableBlock


def graph_from_numpy(blocks: dict, batches: list, dtype, device=None) -> FactorGraph:
    """``blocks``: name -> dict(kind, values, const_mask).
    ``batches``: list of dict(kind, slots, indices, data, weight, loss),
    where ``loss`` is ``(class name, {field: value})``, for example
    ``("CauchyLoss", {"k": 2.0})``.  Floating arrays become ``dtype``, on
    ``device`` (None: the package's default, the CUDA card).  A ``data``
    array keeps its shape, with or without the factor axis; a camera in
    ``data`` is given the same way as the loss,
    ``("StereoCamera", {"cu": ..., ...})``.  A ``dense_prior__<kinds>``
    batch (a graph that ``marginalize`` produced) registers its kernel
    here when it is not yet registered."""
    from .marginalize import PRIOR_PREFIX, _ensure_dense_prior_kernel

    device = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def datum(v):
        if isinstance(v, tuple):
            name, fields = v
            if name not in sensors.__all__:
                raise ValueError(f"unknown camera {name!r}")
            return getattr(sensors, name)(**fields)
        return tensor(v)

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
        if fb["kind"].startswith(PRIOR_PREFIX):
            _ensure_dense_prior_kernel(tuple(fb["kind"][len(PRIOR_PREFIX):].split("_")))
        loss_name, loss_fields = fb["loss"]
        if loss_name not in losses.__all__:
            raise ValueError(f"unknown loss {loss_name!r}")
        t_batches.append(
            FactorBatch.create(
                kind=fb["kind"],
                slots=fb["slots"],
                indices=[np.asarray(i) for i in fb["indices"]],
                data={k: datum(v) for k, v in fb["data"].items()},
                loss=getattr(losses, loss_name)(**loss_fields),
                weight=tensor(fb["weight"]),
            )
        )
    return FactorGraph(t_blocks, t_batches)
