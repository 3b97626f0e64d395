"""The program's large bundle-adjustment entry:
``pyslam_tpu_torch.solver.schur_large.solve_schur_large`` over a plan
built once by ``prepare_large_ba``.

The graph is the one ``pyslam_tpu_torch.graph.build.bal_graph`` builds with
fixed intrinsics (SE(3) cameras, camera 0 frozen, Euclidean landmarks, one
batch of monocular ``reprojection_bal`` factors with each observation's
camera's f, k1, k2, under the L2 loss, unit ``sqrt_info``), made straight
from the generator's device tensors."""

from __future__ import annotations

import torch


def build(problem: dict, config: dict, device) -> dict:
    from pyslam_tpu_torch.graph.core import FactorBatch, FactorGraph, VariableBlock
    from pyslam_tpu_torch.losses import L2Loss

    dtype = getattr(torch, config["dtype"])
    poses = problem["poses_init"].to(dtype).contiguous()
    lms = problem["pts_init"].to(dtype).contiguous()
    anchor = torch.zeros(poses.shape[0], dtype=torch.bool, device=device)
    anchor[0] = True
    blocks = {
        "poses": VariableBlock("se3", poses, anchor),
        "landmarks": VariableBlock("euclidean", lms, torch.zeros(lms.shape[0], dtype=torch.bool, device=device)),
    }
    obs = problem["obs"].to(dtype).contiguous()
    f, k1, k2 = problem["intrinsics"].to(dtype)[problem["cam_idx"]].unbind(-1)
    batch = FactorBatch(
        "reprojection_bal", ("poses", "landmarks"), (problem["cam_idx"], problem["pt_idx"]),
        {"obs": obs, "sqrt_info": torch.eye(2, dtype=dtype, device=device),
         "f": f.contiguous(), "k1": k1.contiguous(), "k2": k2.contiguous()},
        L2Loss(), torch.ones(obs.shape[0], dtype=dtype, device=device),
    )
    return dict(graph=FactorGraph(blocks, [batch]), config=config, start=(poses.clone(), lms.clone()))


def plan(state: dict) -> None:
    from pyslam_tpu_torch.solver.schur_large import prepare_large_ba

    state["plan"] = prepare_large_ba(state["graph"], int(state["config"]["solver"]["n_chunks"]))


def restore(state: dict) -> None:
    """The start state back into the plan, which every solve starts from."""
    plan = state["plan"]
    plan.poses.copy_(state["start"][0])
    plan.lms.copy_(state["start"][1])


def solve(state: dict) -> dict:
    from pyslam_tpu_torch.solver import Options
    from pyslam_tpu_torch.solver.schur_large import solve_schur_large

    cfg = state["config"]
    solved, chi2, history = solve_schur_large(state["graph"], Options(**cfg["options"]), plan=state["plan"],
                                              **cfg["solver"])
    # history: the accepted costs, the start's first
    return dict(chi2=float(chi2), poses=solved.blocks["poses"].values, landmarks=solved.blocks["landmarks"].values,
                first_cost=lambda: history[1] if len(history) > 1 else float("nan"))
