"""kernels_per_solve (kernels, device trace): kernels the card ran a solve
in the profiled solves, copies and fills not counted: the host's launches
that pace a host-bound solve."""


def read(run):
    s = run.summary
    if s is None or not s.kernels or not s.solves:
        return None
    return len(s.kernels) / s.solves
