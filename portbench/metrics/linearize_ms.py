"""linearize_ms (ms, program span): host ms a solve spends in the Schur
path's linearization (``schur_large._linearize``: the chunked factor
kernel and the sums by camera and by landmark), from a span the benchmark
puts around the calls, in the solves the profiler did not slow."""

from portbench.probes import Span

PROBES = [Span("linearize", "pyslam_tpu_torch.solver.schur_large:_linearize")]


def read(run):
    return run.span_ms("linearize")
