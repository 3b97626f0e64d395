"""host_wait_ms (ms, program span): host ms a solve spent blocked on the
card, in the program's ``read`` spans (every device-to-host read of the
solver loops and every other synchronising call of a solve), over the
solves no profile slowed."""

from portbench import spans

PROBES = [spans.span_ns("read")]


def read(run):
    return spans.steady_ms(run, "read")
