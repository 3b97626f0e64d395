"""solve_ms (ms, host clock): the window's whole wall over the solves it
completed, each from the start state restored on the card to the
converged chi2 read back on the host."""


def read(run):
    return 1e3 * run.window_s / len(run.solves)
