"""The card's idle share of the traced steps, in %: 1 - (the union of every
device operation's interval) / (the traced stretch's wall time)."""


def read(run):
    if run.trace is None or run.unit != "tokens" or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.wall_s)
