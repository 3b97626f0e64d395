"""schur_pcg_ms (ms, program span): host ms a solve spends in the Schur
path's conjugate gradients (``schur_large._pcg`` over
``schur.schur_matvec``), from a span the benchmark puts around the calls,
in the solves the profiler did not slow."""

from portbench.probes import Span

PROBES = [Span("schur_pcg", "pyslam_tpu_torch.solver.schur_large:_pcg")]


def read(run):
    return run.span_ms("schur_pcg")
