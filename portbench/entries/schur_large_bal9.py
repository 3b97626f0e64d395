"""The program's large bundle-adjustment entry on BAL's 9-parameter
cameras: ``pyslam_tpu_torch.solver.schur_large.solve_schur_large`` over a
plan built once by ``prepare_large_ba``, as ``entries/schur_large.py`` runs
it.

The graph: ``bal_cam9`` cameras (C, 19) = [vec(T), f, k1, k2] from the
generator's start, camera 0 frozen whole by the constant mask (its pose and
its intrinsics), Euclidean landmarks, and one batch of monocular
``reprojection_bal9`` factors under the L2 loss with unit ``sqrt_info``,
made straight from the generator's device tensors."""

from __future__ import annotations

import torch

from .schur_large import plan, restore, solve  # noqa: F401  (the same plan, restore and solve)


def build(problem: dict, config: dict, device) -> dict:
    from pyslam_tpu_torch.graph.core import FactorBatch, FactorGraph, VariableBlock
    from pyslam_tpu_torch.losses import L2Loss

    dtype = getattr(torch, config["dtype"])
    C = problem["poses_init"].shape[0]
    cams = torch.cat([problem["poses_init"].reshape(C, 16), problem["intrinsics_init"]], -1).to(dtype).contiguous()
    lms = problem["pts_init"].to(dtype).contiguous()
    anchor = torch.zeros(C, dtype=torch.bool, device=device)
    anchor[0] = True
    blocks = {
        "poses": VariableBlock("bal_cam9", cams, anchor),
        "landmarks": VariableBlock("euclidean", lms, torch.zeros(lms.shape[0], dtype=torch.bool, device=device)),
    }
    obs = problem["obs"].to(dtype).contiguous()
    batch = FactorBatch(
        "reprojection_bal9", ("poses", "landmarks"), (problem["cam_idx"], problem["pt_idx"]),
        {"obs": obs, "sqrt_info": torch.eye(2, dtype=dtype, device=device)},
        L2Loss(), torch.ones(obs.shape[0], dtype=dtype, device=device),
    )
    return dict(graph=FactorGraph(blocks, [batch]), config=config, start=(cams.clone(), lms.clone()))
