"""Tokens trained per second per card: every token of the window's steps,
over the window's wall time (first step's start to the synchronise after
the last), over the cell's cards."""


def read(run):
    if run.unit != "tokens":
        return None
    return run.steps * run.units_per_step / run.window_s / run.chips
