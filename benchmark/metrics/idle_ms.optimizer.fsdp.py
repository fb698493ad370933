"""Device milliseconds in the optimizer phase of the port's train step that no
device operation of any stream covers, meaned over the phase's stretches
between the port's device marks (``benchmark/marks.py``):
[``opt``, ``end``) of each traced step: the trainer's all-reduces, the
clip over every DTensor leaf and the update.
Where no mark is lost, the four ``idle_ms.*.fsdp`` tile the idle between
a rank's first mark and its last; the line holds the worst rank's.
Nothing on one card."""

from benchmark import marks


def read(run):
    if run.chips < 2:
        return None
    return marks.idle_ms(run.trace, "optimizer")
