"""lm_iterations (iters, program counter): LM iterations a solve, as the
program's loops report them (``host_lm_loop_speculative``'s info on the
Schur path, ``SolveInfo.iterations`` on ``lm.solve``)."""

from portbench.probes import Call

PROBES = [
    Call("lm_loop_host", "pyslam_tpu_torch.solver.schur_large:host_lm_loop_speculative",
         lambda args, kwargs, out: {"iterations": out[2]["iterations"]}),
    Call("lm_loop_device", "pyslam_tpu_torch.solver.lm:solve",
         lambda args, kwargs, out: {"iterations": out[1].iterations}),
]


def read(run):
    for name in ("lm_loop_host", "lm_loop_device"):
        value = run.per_solve(name, lambda r: r["iterations"])
        if value is not None:
            return value
    return None
