"""host_work_ms (ms, program span): the host's own work in a solve, the
program's outermost ``solve`` span less the ``read`` spans inside it, over
the solves no profile slowed.  With ``host_wait_ms`` it makes up the solve's
host time."""

from portbench import spans

PROBES = [spans.span_ns("solve"), spans.span_ns("read")]


def read(run):
    return spans.steady_ms(run, "solve", minus="read")
