"""solve_p90_ms (ms, host clock): the 90th percentile of the times of all
the window's solves, each from the start state restored on the card to
the converged chi2 read back on the host."""

import statistics


def read(run):
    times = [1e3 * s.seconds for s in run.solves]
    return statistics.quantiles(times, n=10)[8] if len(times) > 1 else times[0]
