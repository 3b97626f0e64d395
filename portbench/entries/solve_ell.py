"""The program's large pose-graph entry: ``pyslam_tpu_torch.solver.bcsr.
solve_ell`` (direct-to-ELL assembly, the ``ell_assemble`` and ``ell_pcg``
kernels) over a plan built once by ``build_ell_direct``.

The graph is the one ``pyslam_tpu_torch.graph.build.pose_graph`` builds for
SE(3) data (one ``se3`` block, pose 0 frozen, one ``between_se3`` batch
under the L2 loss), made straight from the generator's device tensors."""

from __future__ import annotations

import torch


def build(problem: dict, config: dict, device) -> dict:
    from pyslam_tpu_torch.graph.core import FactorBatch, FactorGraph, VariableBlock
    from pyslam_tpu_torch.losses import L2Loss

    dtype = getattr(torch, config["dtype"])
    poses = problem["poses_init"].to(dtype).contiguous()
    anchor = torch.zeros(poses.shape[0], dtype=torch.bool, device=device)
    anchor[0] = True
    T_obs = problem["T_meas"].to(dtype).contiguous()
    batch = FactorBatch(
        "between_se3", ("poses", "poses"), (problem["edges_i"], problem["edges_j"]),
        {"T_obs": T_obs, "sqrt_info": problem["sqrt_info"].to(dtype).contiguous()},
        L2Loss(), torch.ones(T_obs.shape[0], dtype=dtype, device=device),
    )
    graph = FactorGraph({"poses": VariableBlock("se3", poses, anchor)}, [batch])
    return dict(graph=graph, config=config, start=poses.clone())


def plan(state: dict) -> None:
    from pyslam_tpu_torch.solver.bcsr import build_ell_direct

    state["plan"] = build_ell_direct(state["graph"])


def restore(state: dict) -> None:
    state["graph"].blocks["poses"].values.copy_(state["start"])


def solve(state: dict) -> dict:
    from pyslam_tpu_torch.solver import Options
    from pyslam_tpu_torch.solver.bcsr import solve_ell

    cfg = state["config"]
    solved, info = solve_ell(state["graph"], Options(**cfg["options"]), plan=state["plan"], **cfg["solver"])
    return dict(chi2=float(info.chi2), poses=solved.blocks["poses"].values, first_cost=lambda: _first_cost(info))


def _first_cost(info) -> float:
    """The cost after the first accepted LM step, read from the solve's
    history once the window has closed."""
    accepted = info.accepted[: info.iterations].tolist()
    if True not in accepted:
        return float("nan")
    return float(info.cost_history[accepted.index(True) + 1])
