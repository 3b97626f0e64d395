"""ell_plan_ms (ms, program span): host ms a solve spends in the program's
``ell.device_plan`` span, the ELL path's slot plans and assemble tables
built on the host and copied to the card inside every ``solve_ell``, over
the solves no profile slowed."""

from portbench import spans

PROBES = [spans.span_ns("ell.device_plan")]


def read(run):
    return spans.steady_ms(run, "ell.device_plan")
