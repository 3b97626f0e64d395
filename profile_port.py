#!/usr/bin/env python3
"""Profile of the PyTorch + CUDA port's solves on one NVIDIA GPU: the wall
time, the device's busy share and, for the dense cells, the host time of
each phase of an iteration.

    python3 profile_port.py [--cells sphere2500,config1,config2,config7]
                            [--reps 7] [--root DIR]

Each cell is the one ``chip_smoke.py`` drives (f32, the reference
harness's options).  Per cell:

  * wall: one warm-up solve, then the median of ``--reps`` solves, each
    timed on the host clock from the call to the converged chi2 read back
    with ``.item()``;
  * busy share: one more solve under ``torch.profiler``
    (CPU and CUDA activities); the summed self device time of its kernel
    events divided by the unprofiled median wall.  Also the kernels
    launched per solve and the ten longest kernels;
  * host ms per call (dense cells): ``dense_plan``, the linearization
    (``dense_contributions``), ``assemble_dense``, ``cholesky_ex``,
    ``_dense_solve`` and ``retract_all`` at the start point, each the
    median of ``--reps`` calls after one warm-up, every call closed by
    ``torch.cuda.synchronize()``;
  * host ms per call (sphere2500), measured the same way:
    ``ell_device_plan``, the linearization, ``assemble_ell``, the damping
    with ``sym_block_inv``, one PCG linear solve at the start point (the
    ``ell_pcg`` kernel; on a checkout from before that kernel, the host
    loop over ``ell_matvec`` that ``solve_ell`` ran then) and
    ``retract_all``;
  * the runtime's stream and device synchronisations and memory copies
    counted in the profiled solve.

``--root`` imports ``pyslam_tpu_torch`` from another checkout, such as a
parent commit unpacked beside this one (the sphere2500 cell runs on every
version of the port; the dense cells need the dense path).  The graphs
are built on the package's default device, the CUDA card; a checkout from
before ``default_device`` is given ``cuda:0`` by name.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time

CELLS = ("sphere2500", "config1", "config2", "config7")
RUNTIME_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")


def host_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def make_cell(name, dev):
    """(graph, run) of one cell: ``run()`` solves and returns (solved, info)."""
    import torch

    from pyslam_tpu_torch.graph import build
    from pyslam_tpu_torch.io import synth
    from pyslam_tpu_torch.solver.lm import Options

    if name == "sphere2500":
        from pyslam_tpu_torch.solver.bcsr import build_ell_direct, solve_ell

        g = build.pose_graph(synth.se3_sphere(n_poses=2500, seed=0), dtype=torch.float32, device=dev)
        plan = build_ell_direct(g)
        o = Options(method="lm", max_iters=30, min_cost_decrease=0.999)
        return g, o, lambda: solve_ell(g, o, plan=plan, pcg_rtol=3e-6, pcg_max_iters=120)

    from pyslam_tpu_torch.io import g2o
    from pyslam_tpu_torch.losses import CauchyLoss
    from pyslam_tpu_torch.solver import solve

    if name == "config1":
        g = build.pose_graph(synth.se2_loop(n_poses=100, n_loops=12, seed=0), loss=CauchyLoss(2.0), device=dev)
        o = Options(method="lm", max_iters=50)
    elif name == "config2":
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "m3500.g2o")
            g2o.write_g2o(path, synth.se2_manhattan(n_poses=3500, seed=1))
            g = build.pose_graph(g2o.read_g2o(path), device=dev)
        o = Options(method="gn", max_iters=30, min_cost_decrease=0.999)
    elif name == "config7":
        data = synth.sim3_loop(n_poses=400, n_loops=10, scale_drift=0.005, odo_scale_std=0.005, seed=0)
        g = build.sim3_pose_graph(data, device=dev)
        o = Options(method="lm", max_iters=50)
    else:
        raise SystemExit(f"unknown cell {name!r}; cells: {', '.join(CELLS)}")
    return g, o, lambda: solve(g, o)


def dense_split(g, o, dev, reps):
    import torch

    from pyslam_tpu_torch.solver import assemble
    from pyslam_tpu_torch.solver.lm import _dense_solve

    plan = assemble.dense_plan(g)
    H, gv, _ = assemble.assemble_dense(g, plan)
    lam = torch.tensor(o.lambda_init, dtype=H.dtype, device=dev)
    dx = _dense_solve(H, gv, lam, o)
    return dict(
        dense_plan=host_ms(lambda: assemble.dense_plan(g), reps),
        linearize=host_ms(lambda: assemble.dense_contributions(g, hessian=True), reps),
        assemble_dense=host_ms(lambda: assemble.assemble_dense(g, plan), reps),
        cholesky_ex=host_ms(lambda: torch.linalg.cholesky_ex(H), reps),
        dense_solve=host_ms(lambda: _dense_solve(H, gv, lam, o), reps),
        retract_all=host_ms(lambda: g.retract_all(dx), reps),
    )


def ell_split(g, o, dev, reps):
    import torch

    from pyslam_tpu_torch.solver import bcsr, cuda_ops

    plan = bcsr.build_ell_direct(g)
    dplan = bcsr.ell_device_plan(plan, dev)
    He, gv, _ = bcsr.assemble_ell(g, dplan)

    def damp():
        D = He[:, 0]
        diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=1e-12)
        He_d = He.clone()
        He_d[:, 0] = D + o.lambda_init * torch.diag_embed(diag)
        return He_d, bcsr.sym_block_inv(He_d[:, 0])

    He_d, Minv = damp()
    if hasattr(cuda_ops, "ell_pcg"):
        def pcg():
            return cuda_ops.ell_pcg(He_d, dplan.cols, Minv, gv, 3e-6, 120).x
    else:  # before the ell_pcg kernel: the host loop of that solve_ell
        from pyslam_tpu_torch.solver.linear import pcg_solve

        def pcg():
            return pcg_solve(
                lambda x: cuda_ops.ell_matvec(He_d, dplan.cols, x), gv,
                precond=lambda r: (Minv @ r.reshape(plan.nb, plan.d, 1)).reshape(-1), rtol=3e-6, max_iters=120,
            )[0]

    dx = pcg()
    return dict(
        ell_device_plan=host_ms(lambda: bcsr.ell_device_plan(plan, dev), reps),
        linearize=host_ms(lambda: bcsr.ell_contributions(g, plan), reps),
        assemble_ell=host_ms(lambda: bcsr.assemble_ell(g, dplan), reps),
        damp_and_block_inverse=host_ms(damp, reps),
        pcg_linear_solve=host_ms(pcg, reps),
        retract_all=host_ms(lambda: g.retract_all(dx), reps),
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is False: no GPU to run on", file=sys.stderr)
        return 1
    import pyslam_tpu_torch  # noqa: F401  (sets the TF32 flags)

    dev = pyslam_tpu_torch.default_device() if hasattr(pyslam_tpu_torch, "default_device") else torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"({smi.stdout.strip() or 'nvidia-smi not available'}); "
          f"pyslam_tpu_torch from {os.path.dirname(pyslam_tpu_torch.__file__)}", flush=True)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    for name in args.cells.split(","):
        g, o, run = make_cell(name, dev)
        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            _, info = run()
            chi2 = info.chi2.item()
            walls.append(1e3 * (time.perf_counter() - t0))
        wall = statistics.median(walls)
        print(f"== {name}: wall median of {args.reps} {wall!r} ms (all {[round(w, 3) for w in walls]}); "
              f"LM iterations {info.iterations} status {info.status} chi2 {chi2!r}", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, info = run()
            info.chi2.item()
            pwall = 1e3 * (time.perf_counter() - t0)
        ka = prof.key_averages()
        kern = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(dev_us(e) for e in kern) / 1e3
        print(f"   profiled wall {pwall!r} ms; device time summed {busy!r} ms -> busy share {busy / wall!r}; "
              f"kernels launched per solve {sum(e.count for e in kern)}")
        print(f"   runtime calls per solve {({e.key: e.count for e in ka if e.key in RUNTIME_CALLS})}")
        for e in sorted(kern, key=dev_us, reverse=True)[:10]:
            print(f"   {dev_us(e) / 1e3:10.4f} ms  x{e.count:5d}  {e.key[:110]}")
        split = ell_split(g, o, dev, args.reps) if name == "sphere2500" else dense_split(g, o, dev, args.reps)
        print(f"   host ms per call (median of {args.reps}, synchronised): {split}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
