"""Builders: dataset containers -> FactorGraph.

Counterpart of ``pyslam_tpu/graph/build.py``.  Ported so far: the SE(3)
path of ``pose_graph``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..losses import L2Loss
from .core import FactorBatch, FactorGraph, VariableBlock


def pose_graph(
    data,
    loss=None,
    anchor_first: bool = True,
    dtype=torch.float32,
    init: str = "odometry",
    device="cpu",
) -> FactorGraph:
    """Build an SE(3) pose-graph FactorGraph from PoseGraphData, with every
    tensor in ``dtype`` on ``device``.

    ``anchor_first`` freezes pose 0 (gauge fixing).  ``init`` is
    'odometry' (integrated measurements, the standard benchmark init) or
    'gt'.  SE(2) and Sim(3) graphs and the 'spanning_tree' / 'chordal'
    inits are not ported yet and raise NotImplementedError.
    """
    loss = loss if loss is not None else L2Loss()
    if data.dim != 3 or data.sqrt_info.shape[-1] != 6:
        raise NotImplementedError("pose_graph: only SE(3) graphs are ported (no SE(2), Sim(3))")
    if init == "gt":
        T0 = data.T_gt
    elif init == "odometry":
        T0 = data.T_init
    else:
        raise NotImplementedError(f"pose_graph: init={init!r} is not ported ('odometry', 'gt')")
    n = T0.shape[0]
    const = np.zeros(n, bool)
    if anchor_first:
        const[0] = True

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    blocks = {
        "poses": VariableBlock.create("se3", tensor(T0), torch.as_tensor(const, device=device))
    }
    batch = FactorBatch.create(
        kind="between_se3",
        slots=("poses", "poses"),
        indices=(np.asarray(data.edges_i), np.asarray(data.edges_j)),
        data={"T_obs": tensor(data.T_meas), "sqrt_info": tensor(data.sqrt_info)},
        loss=loss,
    )
    return FactorGraph(blocks, [batch])
