"""Builders: dataset containers -> FactorGraph.

Counterpart of ``pyslam_tpu/graph/build.py``.  Ported so far:
``pose_graph`` (SE(2), SE(3), and Sim(3) data routed to
``sim3_pose_graph``) and ``sim3_pose_graph``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..losses import L2Loss
from .core import FactorBatch, FactorGraph, VariableBlock


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _single_between_graph(kind, T0, data, loss, anchor_first, dtype, device):
    """One block of poses of ``kind`` and one ``between_<kind>`` batch."""
    device = resolve_device(device)
    const = np.zeros(T0.shape[0], bool)
    if anchor_first:
        const[0] = True
    blocks = {
        "poses": VariableBlock.create(kind, _tensor(T0, dtype, device), torch.as_tensor(const, device=device))
    }
    batch = FactorBatch.create(
        kind=f"between_{kind}",
        slots=("poses", "poses"),
        indices=(np.asarray(data.edges_i), np.asarray(data.edges_j)),
        data={
            "T_obs": _tensor(data.T_meas, dtype, device),
            "sqrt_info": _tensor(data.sqrt_info, dtype, device),
        },
        loss=loss,
    )
    return FactorGraph(blocks, [batch])


def pose_graph(
    data,
    loss=None,
    anchor_first: bool = True,
    dtype=torch.float32,
    init: str = "odometry",
    device=None,
) -> FactorGraph:
    """Build a pose-graph FactorGraph from PoseGraphData (2D or 3D), with
    every tensor in ``dtype`` on ``device`` (None: the package's default,
    the CUDA card; ``device="cpu"`` asks for the CPU).

    ``anchor_first`` freezes pose 0 (gauge fixing).  ``init`` is
    'odometry' (integrated measurements, the standard benchmark init) or
    'gt'.  3D data with 7-dof ``sqrt_info`` is a Sim(3) graph and goes to
    ``sim3_pose_graph``.  The 'spanning_tree' / 'chordal' inits are not
    ported yet and raise NotImplementedError (ValueError on Sim(3) data,
    where the reference has no such init either).
    """
    loss = loss if loss is not None else L2Loss()
    if data.dim == 3 and data.sqrt_info.shape[-1] == 7:
        # 'chordal' / 'spanning_tree' are SE-only constructions
        if init in ("chordal", "spanning_tree"):
            raise ValueError(
                f"init={init!r} is not implemented for Sim(3) graphs; use "
                "'odometry' (default) or 'gt'"
            )
        return sim3_pose_graph(
            data, loss=loss, anchor_first=anchor_first, dtype=dtype, init=init, device=device
        )
    if init == "gt":
        T0 = data.T_gt
    elif init == "odometry":
        T0 = data.T_init
    else:
        raise NotImplementedError(f"pose_graph: init={init!r} is not ported ('odometry', 'gt')")
    kind = "se2" if data.dim == 2 else "se3"
    return _single_between_graph(kind, T0, data, loss, anchor_first, dtype, device)


def sim3_pose_graph(
    data,
    loss=None,
    anchor_first: bool = True,
    dtype=torch.float32,
    init: str = "odometry",
    device=None,
) -> FactorGraph:
    """Build a Sim(3) pose-graph FactorGraph (scale-drift-aware monocular
    loop closure; see ``lie/sim3.py`` and ``synth.sim3_loop``).

    ``data`` is PoseGraphData whose (N, 4, 4) matrices are Sim(3)
    ``[[s*R, t], [0, 1]]`` and whose sqrt_info is (E, 7, 7).  ``init``
    'gt' starts from the ground truth, anything else from ``T_init``.
    ``device`` as in ``pose_graph``."""
    loss = loss if loss is not None else L2Loss()
    T0 = data.T_gt if init == "gt" else data.T_init
    return _single_between_graph("sim3", T0, data, loss, anchor_first, dtype, device)
