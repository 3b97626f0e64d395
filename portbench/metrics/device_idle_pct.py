"""device_idle_pct (%, device trace): 100 x (1 - the union of the card's
operations over the profiled solves' host-clock wall)."""


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
