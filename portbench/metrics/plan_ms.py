"""plan_ms (ms, host clock): the program's plan of the graph's structure
at set-up (``schur_large.prepare_large_ba`` or ``bcsr.build_ell_direct``),
from a synchronised card to a synchronised card."""


def read(run):
    return 1e3 * run.plan_s
