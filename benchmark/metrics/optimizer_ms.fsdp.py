"""``optimizer_ms.decoder``'s reading in a cell on several cards (the worst
rank's): the loss's all-reduce, the clip over every DTensor leaf and the
update of the local shards, where it moves the gang's own rate; nothing on
one card."""

from benchmark import marks


def read(run):
    if run.chips < 2:
        return None
    return marks.phase_ms(run.trace, "optimizer")
