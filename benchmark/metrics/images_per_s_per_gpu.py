"""Images trained per second per card: every image of the window's steps,
over the window's wall time (first step's start to the synchronise after
the last), over the cell's cards."""


def read(run):
    if run.unit != "images":
        return None
    return run.steps * run.units_per_step / run.window_s / run.chips
