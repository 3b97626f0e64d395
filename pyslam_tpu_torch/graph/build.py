"""Builders: dataset containers -> FactorGraph.

Counterpart of ``pyslam_tpu/graph/build.py``: ``pose_graph`` (SE(2),
SE(3), and Sim(3) data routed to ``sim3_pose_graph``; the 'odometry',
'gt', 'spanning_tree' and 'chordal' inits), ``switchable_pose_graph``,
``sim3_pose_graph``, ``landmark_slam_2d``, ``ba_graph`` and ``bal_graph``.
Every builder puts its tensors in ``dtype`` on ``device`` (None: the
package's default, the CUDA card; ``device="cpu"`` asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..losses import L2Loss
from ..sensors import StereoCamera
from .core import FactorBatch, FactorGraph, VariableBlock
from .initialize import chordal_init, spanning_tree_init


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _pose_block(kind, values, anchor_first, dtype, device):
    """A block of ``kind`` from (N, ...) values, element 0 frozen (gauge
    fixing) where ``anchor_first``."""
    const = np.zeros(values.shape[0], bool)
    if anchor_first:
        const[0] = True
    return VariableBlock.create(kind, _tensor(values, dtype, device), torch.as_tensor(const, device=device))


def _between_batch(kind, data, loss, dtype, device):
    return FactorBatch.create(
        kind=f"between_{kind}",
        slots=("poses", "poses"),
        indices=(np.asarray(data.edges_i), np.asarray(data.edges_j)),
        data={
            "T_obs": _tensor(data.T_meas, dtype, device),
            "sqrt_info": _tensor(data.sqrt_info, dtype, device),
        },
        loss=loss,
    )


def _single_between_graph(kind, T0, data, loss, anchor_first, dtype, device):
    """One block of poses of ``kind`` and one ``between_<kind>`` batch."""
    device = resolve_device(device)
    blocks = {"poses": _pose_block(kind, T0, anchor_first, dtype, device)}
    return FactorGraph(blocks, [_between_batch(kind, data, loss, dtype, device)])


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
    'odometry' (integrated measurements, the standard benchmark init),
    'gt', 'spanning_tree' (BFS measurement integration, for datasets with
    no vertex estimates) or 'chordal' (the two-stage linear relaxation of
    ``graph/initialize.py``, solved in ``dtype`` on ``device``; closest to
    the optimum's basin, at the cost of two linear solves).  3D data with
    7-dof ``sqrt_info`` is a Sim(3) graph and goes to ``sim3_pose_graph``,
    where 'spanning_tree' / 'chordal' raise ValueError.
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
    device = resolve_device(device)
    n_poses = data.T_init.shape[0]
    if init == "chordal":
        T0 = chordal_init(data.edges_i, data.edges_j, data.T_meas, n_poses, dtype=dtype, device=device)
    elif init == "spanning_tree":
        T0 = spanning_tree_init(data.edges_i, data.edges_j, data.T_meas, n_poses)
    elif init == "gt":
        T0 = data.T_gt
    else:
        T0 = data.T_init
    kind = "se2" if data.dim == 2 else "se3"
    return _single_between_graph(kind, T0, data, loss, anchor_first, dtype, device)


def switchable_pose_graph(
    data,
    loss=None,
    anchor_first: bool = True,
    dtype=torch.float32,
    init: str = "odometry",
    xi=5.0,
    loop_mask=None,
    s_init=None,
    device=None,
) -> FactorGraph:
    """Pose graph with switchable loop closures (Suenderhauf & Protzel ICRA
    2012): odometry edges stay plain between factors; each loop edge gets a
    scalar switch variable (block "switches", init 1.0) through the
    ``between_*_switch`` kernel, whose xi-weighted prior row lets wrong
    loop closures turn themselves off during optimization.  The
    weight-based alternative is ``solver.solve_gnc``.

    ``xi`` sets the switch prior stiffness (5 separates inliers from
    outliers on the reference's tests).  ``xi`` and ``s_init`` may be
    per-loop-edge arrays, straight from ``io.g2o.read_g2o_switchable``:
    ``build.switchable_pose_graph(data, **sw)``.

    ``loop_mask``: boolean (E,) marking the loop closures; defaults to
    non-consecutive edges (|i - j| != 1).  A loop-free graph gets one
    placeholder switch that no factor touches.  The converged switches are
    ``solved.blocks["switches"].values[:, 0]``: near 0, the edge was
    rejected.  Solve with ``solver.solve`` (the dense path: a graph of two
    blocks coupled only by 3-slot factors is outside the Schur routes).
    Tensors in ``dtype`` on ``device`` as in ``pose_graph``."""
    device = resolve_device(device)
    loss = loss if loss is not None else L2Loss()
    kind = "se2" if data.dim == 2 else "se3"
    T0 = data.T_gt if init == "gt" else data.T_init
    ei = np.asarray(data.edges_i)
    ej = np.asarray(data.edges_j)
    if loop_mask is None:
        loop_mask = np.abs(ei - ej) != 1
    loop_mask = np.asarray(loop_mask, bool)
    odo = ~loop_mask
    n_loops = int(loop_mask.sum())
    if s_init is None or n_loops == 0:
        # n_loops == 0: the placeholder switch ignores any (0,)-shaped
        # s_init from read_g2o_switchable on a loop-free file
        s0 = np.ones((max(n_loops, 1), 1))
    else:
        s0 = np.broadcast_to(np.asarray(s_init, np.float64).reshape(-1, 1), (n_loops, 1))
    T_meas, sqrt_info = np.asarray(data.T_meas), np.asarray(data.sqrt_info)
    blocks = {
        "poses": _pose_block(kind, T0, anchor_first, dtype, device),
        "switches": VariableBlock.create("euclidean", _tensor(s0, dtype, device)),
    }
    batches = [
        FactorBatch.create(
            kind=f"between_{kind}",
            slots=("poses", "poses"),
            indices=(ei[odo], ej[odo]),
            data={"T_obs": _tensor(T_meas[odo], dtype, device), "sqrt_info": _tensor(sqrt_info[odo], dtype, device)},
            loss=loss,
        ),
        FactorBatch.create(
            kind=f"between_{kind}_switch",
            slots=("poses", "poses", "switches"),
            indices=(ei[loop_mask], ej[loop_mask], np.arange(n_loops, dtype=np.int32)),
            data={
                "T_obs": _tensor(T_meas[loop_mask], dtype, device),
                "sqrt_info": _tensor(sqrt_info[loop_mask], dtype, device),
                "xi": _tensor(np.broadcast_to(np.asarray(xi, np.float64), (n_loops,)), dtype, device),
            },
            loss=loss,
        ),
    ]
    return FactorGraph(blocks, batches)


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


def landmark_slam_2d(
    data,
    loss=None,
    anchor_first: bool = True,
    dtype=torch.float32,
    init: str = "noisy",
    device=None,
) -> FactorGraph:
    """Build a 2D landmark-SLAM FactorGraph from synth.LandmarkSLAM2DData
    (or io.g2o landmark files): SE(2) poses + 2-dof euclidean landmarks,
    odometry between factors + bearing-range / relative-position landmark
    observations.  ``solve_schur`` takes this shape: ``solver/schur.py`` is
    dof-generic."""
    device = resolve_device(device)
    loss = loss if loss is not None else L2Loss()
    T0 = data.T_init if init == "noisy" else data.T_gt
    l0 = data.lm_init if init == "noisy" else data.lm_gt
    blocks = {
        "poses": _pose_block("se2", T0, anchor_first, dtype, device),
        "landmarks": VariableBlock.create("euclidean", _tensor(l0, dtype, device)),
    }
    kind = "bearing_range_se2" if data.obs_type == "bearing_range" else "landmark_xy_se2"
    batches = [
        FactorBatch.create(
            kind=kind,
            slots=("poses", "landmarks"),
            indices=(data.obs_pose, data.obs_lm),
            data={
                "obs": _tensor(data.obs, dtype, device),
                "sqrt_info": _tensor(data.obs_sqrt_info, dtype, device),
            },
            loss=loss,
        )
    ]
    if len(data.edges_i):
        batches.append(_between_batch("se2", data, loss, dtype, device))
    return FactorGraph(blocks, batches)


def ba_graph(data, loss=None, dtype=torch.float32, init: str = "noisy", device=None) -> FactorGraph:
    """Build a bundle-adjustment FactorGraph from BAData: SE(3) camera poses
    (camera 0 frozen: the gauge anchor) + Euclidean landmarks + stereo
    reprojection factors."""
    device = resolve_device(device)
    loss = loss if loss is not None else L2Loss()
    T0 = data.T_init if init == "noisy" else data.T_gt
    p0 = data.pts_init if init == "noisy" else data.pts_gt
    blocks = {
        "poses": _pose_block("se3", T0, True, dtype, device),
        "landmarks": VariableBlock.create("euclidean", _tensor(p0, dtype, device)),
    }
    batch = FactorBatch.create(
        kind="reprojection",
        slots=("poses", "landmarks"),
        indices=(data.cam_idx, data.pt_idx),
        data={
            "obs": _tensor(data.obs, dtype, device),
            # one (3, 3) matrix for the whole batch: the kernels broadcast it
            "sqrt_info": torch.eye(3, dtype=dtype, device=device),
            "camera": StereoCamera(**data.camera),
        },
        loss=loss,
    )
    return FactorGraph(blocks, [batch])


def bal_graph(
    data,
    loss=None,
    pixel_std=1.0,
    anchor_first=True,
    dtype=torch.float32,
    optimize_intrinsics: bool = False,
    device=None,
) -> FactorGraph:
    """Build a monocular BA FactorGraph from io.bal.BALData (Snavely camera
    model).

    ``optimize_intrinsics=False`` (default) holds [f, k1, k2] fixed at the
    file values.  ``True`` builds the full BAL problem: 9-dof cameras with
    the intrinsics optimized jointly, as one ``bal_cam9`` product-manifold
    block, so that the Schur path applies."""
    device = resolve_device(device)
    loss = loss if loss is not None else L2Loss()
    n_cams = data.T.shape[0]
    sqrt_info = torch.eye(2, dtype=dtype, device=device) / pixel_std
    blocks = {"landmarks": VariableBlock.create("euclidean", _tensor(data.pts, dtype, device))}
    indices = (data.cam_idx, data.pt_idx)
    obs = _tensor(data.obs, dtype, device)
    if optimize_intrinsics:
        packed = np.concatenate([data.T.reshape(n_cams, 16), np.asarray(data.intrinsics)], axis=1)
        # gauge fixing must pin only the POSE dofs of camera 0: a const mask
        # would freeze the whole 9-dof block and with it the anchor camera's
        # intrinsics, so the anchor is a stiff pose-only prior instead
        blocks["poses"] = VariableBlock.create("bal_cam9", _tensor(packed, dtype, device))
        batches = [
            FactorBatch.create(
                kind="reprojection_bal9",
                slots=("poses", "landmarks"),
                indices=indices,
                data={"obs": obs, "sqrt_info": sqrt_info},
                loss=loss,
            )
        ]
        if anchor_first:
            batches.append(
                FactorBatch.create(
                    kind="prior_balcam_pose",
                    slots=("poses",),
                    indices=(np.zeros(1, np.int32),),
                    data={
                        "T_obs": _tensor(data.T[:1], dtype, device),
                        "sqrt_info": _tensor(np.eye(6)[None] * 1e6, dtype, device),
                    },
                    loss=L2Loss(),
                )
            )
        return FactorGraph(blocks, batches)
    intr = _tensor(np.asarray(data.intrinsics)[data.cam_idx], dtype, device)
    blocks["poses"] = _pose_block("se3", data.T, anchor_first, dtype, device)
    batch = FactorBatch.create(
        kind="reprojection_bal",
        slots=("poses", "landmarks"),
        indices=indices,
        data={"obs": obs, "sqrt_info": sqrt_info, "f": intr[:, 0], "k1": intr[:, 1], "k2": intr[:, 2]},
        loss=loss,
    )
    return FactorGraph(blocks, [batch])
