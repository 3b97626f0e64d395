"""setup_s (s, host clock): from the start of the process to the first
timed solve: the imports, the kernel library's load (its build in the
first run of a checkout), the problem made on the card, the plan, and
the warm-up solve."""


def read(run):
    return run.setup_s
