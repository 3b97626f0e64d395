"""host_reads (reads, program counter): device-to-host reads a solve made
by the solver loops (``linear.HOST_READS``, LM and CG)."""

from portbench.probes import Counter


def _total():
    from pyslam_tpu_torch.solver.linear import HOST_READS

    return sum(HOST_READS.values())


PROBES = [Counter("host_reads", _total)]


def read(run):
    if run.probes is None:
        return None
    vals = [run.probes.counts.get(("host_reads", i)) for i in range(len(run.solves))]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
