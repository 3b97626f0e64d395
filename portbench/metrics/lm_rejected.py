"""lm_rejected (trials, program counter): LM trials a solve rejected, as the
program's loops count them at their accept decision (``linear.LM_TRIALS``):
each is a linearization and a linear solve thrown away."""

from portbench import spans

PROBES = [spans.trials("rejected")]


def read(run):
    return spans.per_solve_trials(run, "rejected")
