"""The rank side of the tests of ``pyslam_tpu_torch.dist``: what every rank
of a spawned group runs.  It imports neither JAX nor the test modules, so
the spawned processes load only torch and the port.

A job is a dict: ``key``; ``solver`` ("schur", "cm", "pose", "factor", "auto",
"mesh", "marginals": the sharded pose and landmark marginals at the
graph's estimate, ``kw`` their indices and PCG settings, or "problem": a
``Problem`` of ``PoseToPoseResidual`` blocks on SE(2) poses solved with the
mesh, ``kw`` its pose-graph arrays); ``graph``, the arrays ``convert.graph_from_numpy`` takes;
``options``, the ``lm.Options`` fields; ``kw``, the solver's keyword
arguments (a ``partition`` as its ``part`` array).  ``run_jobs`` runs
the jobs in order and returns, for each key, the chi2, the cost history,
the solved values, the lambda of every LM iteration (the accept
sequence), the loop's ``info``, and the collectives and kernel wrapper
calls (``cuda_ops.LAUNCHES``) the solve made.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from pyslam_tpu_torch import dist
from pyslam_tpu_torch.dist import factor_parallel, pose_sharded, schur_cm, schur_reduce
from pyslam_tpu_torch.graph import convert
from pyslam_tpu_torch import solver
from pyslam_tpu_torch.solver import cuda_ops, lm
from pyslam_tpu_torch.testing import run_ranks

_SOLVERS = {
    "schur": (schur_reduce, dist.solve_schur_sharded),
    "pose": (pose_sharded, dist.solve_pose_sharded),
    "factor": (factor_parallel, dist.solve_factor_parallel),
    "cm": (schur_cm, dist.solve_schur_cm),
}


def _recorded(module, record):
    """``module.host_lm_loop`` wrapped to record the lambda of each step and
    the final ``info``."""
    loop = module.host_lm_loop

    def recorded(step, state, options, on_accept=None):
        def rec(state, lam):
            record["lams"].append(lam)
            return step(state, lam)

        out = loop(rec, state, options, on_accept)
        record["info"] = out[2]
        return out

    return recorded


def _solve(mesh, job):
    blocks, batches = job["graph"]
    graph = convert.graph_from_numpy(blocks, batches, torch.float64, device="cpu")
    options = lm.Options(**job.get("options", {}))
    kw = dict(job.get("kw", {}))
    if kw.get("partition") is not None:
        kw["partition"] = dist.Partition(np.asarray(kw["partition"]), mesh.size)
    record = {"lams": []}
    dist.reset_collectives()
    cuda_ops.reset_launches()
    if job["solver"] == "auto":
        # kw "route": the mesh route solve_auto must take; with "force", the
        # route is given to solve_auto, not computed (a graph past the
        # pose_sharded budget is too large for these tests)
        route, force = kw.pop("route"), kw.pop("force", False)
        module = {"factor_parallel": factor_parallel, "pose_sharded": pose_sharded,
                  "schur_reduce": schur_reduce, "schur_cm": schur_cm}[route]
        saved, saved_route = module.host_lm_loop, solver.route_auto
        module.host_lm_loop = _recorded(module, record)
        if force:
            solver.route_auto = lambda *args, **kwargs: route
        try:
            solved, history = solver.solve_auto(graph, options, mesh=mesh, **kw)
        finally:
            module.host_lm_loop, solver.route_auto = saved, saved_route
        chi2 = float(solved.chi2())
    else:
        module, fn = _SOLVERS[job["solver"]]
        saved = module.host_lm_loop
        module.host_lm_loop = _recorded(module, record)
        try:
            solved, chi2, history = fn(graph, mesh, options, **kw)
        finally:
            module.host_lm_loop = saved
    return dict(chi2=chi2, history=list(history), lams=record["lams"], info=record["info"],
                values={n: b.values.numpy() for n, b in solved.blocks.items()},
                collectives=dict(dist.COLLECTIVES), launches=dict(cuda_ops.LAUNCHES))


def _mesh_checks(mesh, job):
    """The two collectives, as every rank sees them."""
    dist.reset_collectives()
    t = torch.full((3,), float(mesh.rank + 1), dtype=torch.float64)
    summed = mesh.psum(t)
    sizes = [r + 1 for r in range(mesh.size)]  # unequal: the gather pads
    gathered = mesh.all_gather(torch.full((mesh.rank + 1, 2), float(mesh.rank)), sizes)
    equal = mesh.all_gather(torch.full((2,), float(mesh.rank)), [2] * mesh.size)
    try:
        mesh.all_gather(torch.zeros(5), [1] * mesh.size)
        wrong_size = None
    except ValueError as e:
        wrong_size = str(e)
    try:
        dist.make_mesh(n_devices=mesh.size + 1, device="cpu")
        wrong_n = None
    except ValueError as e:
        wrong_n = str(e)
    return dict(psum=summed.numpy(), in_place=summed is t, gathered=gathered.numpy(), equal=equal.numpy(),
                collectives=dict(dist.COLLECTIVES), wrong_size=wrong_size, wrong_n=wrong_n, rank=mesh.rank,
                size=mesh.size, backend=mesh.backend, axis_name=mesh.axis_name,
                same_mesh=dist.make_mesh(n_devices=mesh.size, device="cpu") == dist.make_mesh(device="cpu"))


def _marginals(mesh, job):
    """``sharded_pose_marginals`` and ``sharded_landmark_marginals``, with
    the collectives each made."""
    blocks, batches = job["graph"]
    graph = convert.graph_from_numpy(blocks, batches, torch.float64, device="cpu")
    kw = dict(job["kw"])
    poses, lms = kw.pop("poses"), kw.pop("landmarks")
    if kw.get("partition") is not None:
        kw["partition"] = dist.Partition(np.asarray(kw["partition"]), mesh.size)
    dist.reset_collectives()
    pose = dist.sharded_pose_marginals(graph, mesh, poses, **kw)
    pose_collectives = dict(dist.COLLECTIVES)
    dist.reset_collectives()
    lm = dist.sharded_landmark_marginals(graph, mesh, lms, **kw)
    return dict(pose=pose.numpy(), landmarks=lm.numpy(), pose_collectives=pose_collectives,
                lm_collectives=dict(dist.COLLECTIVES))


def pose_graph_problem(arrays, options):
    """A ``Problem`` of one ``PoseToPoseResidual`` an edge of a pose graph's
    arrays (``T_init``, ``edges_i``, ``edges_j``, ``T_meas``,
    ``sqrt_info``), SE(2) poses, f64 on the CPU, the first pose held."""
    from pyslam_tpu_torch import SE2, PoseToPoseResidual, Problem

    names = [f"T_{i}" for i in range(len(arrays["T_init"]))]
    prob = Problem(lm.Options(**options), dtype=torch.float64, device="cpu")
    for i, j, T, S in zip(arrays["edges_i"], arrays["edges_j"], arrays["T_meas"], arrays["sqrt_info"]):
        prob.add_residual_block(PoseToPoseResidual(T, S), [names[int(i)], names[int(j)]])
    prob.initialize_params({n: SE2(T) for n, T in zip(names, arrays["T_init"])})
    prob.set_parameters_constant(names[0])
    return prob


def _problem(mesh, job):
    """``Problem.solve(mesh=...)``: the cost after it and the collectives."""
    prob = pose_graph_problem(job["kw"], job["options"])
    dist.reset_collectives()
    prob.solve(mesh=mesh)
    return dict(cost=float(prob.eval_cost()), summary=[float(c) for c in prob.summary],
                collectives=dict(dist.COLLECTIVES))


def run_jobs(mesh, jobs):
    out = {}
    for job in jobs:
        run = {"mesh": _mesh_checks, "marginals": _marginals, "problem": _problem}.get(job["solver"], _solve)
        out[job["key"]] = run(mesh, job)
    return out


def to_arrays(g):
    """A graph of either package as the arrays ``graph_from_numpy`` takes
    (``np.asarray`` on every leaf; a camera as (class name, fields))."""

    def datum(v):
        return (type(v).__name__, dataclasses.asdict(v)) if dataclasses.is_dataclass(v) else np.asarray(v)

    blocks = {n: dict(kind=b.kind, values=np.asarray(b.values), const_mask=np.asarray(b.const_mask))
              for n, b in g.blocks.items()}
    batches = [dict(kind=fb.kind, slots=tuple(fb.slots), indices=[np.asarray(i) for i in fb.indices],
                    data={k: datum(v) for k, v in fb.data.items()}, weight=np.asarray(fb.weight),
                    loss=(type(fb.loss).__name__, dataclasses.asdict(fb.loss)))
               for fb in g.batches]
    return blocks, batches


_STORE = itertools.count()


def run_group(world_size, jobs, tmp_dir, timeout_s):
    """``run_jobs`` on ``world_size`` gloo ranks, spawned; a world of one
    runs in this process, its group destroyed after.  Every rank's results,
    in rank order.  The ranks are killed, and the call raises, after
    ``timeout_s`` (each caller gives about three times what its groups
    take), so that a hang fails its own tests only."""
    store = tmp_dir / f"group_{world_size}_{next(_STORE)}"
    store.mkdir()
    if world_size > 1:
        return run_ranks(run_jobs, world_size, store, args=(jobs,), timeout_s=timeout_s)
    dist.init_distributed(f"file://{store / 'store'}", 1, 0, device="cpu", timeout_s=timeout_s)
    try:
        return [run_jobs(dist.make_mesh(device="cpu"), jobs)]
    finally:
        torch.distributed.destroy_process_group()
