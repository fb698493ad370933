"""Device milliseconds in the forward phase of the port's train step that no
device operation of any stream covers, meaned over the phase's stretches
between the port's device marks (``benchmark/marks.py``):
[``fwd``, ``bwd``) of each traced step: the forward, with FSDP2's
all-gathers and the hooks around each layer.
Where no mark is lost, the four ``idle_ms.*.fsdp`` tile the idle between
a rank's first mark and its last; the line holds the worst rank's.
Nothing on one card."""

from benchmark import marks


def read(run):
    if run.chips < 2:
        return None
    return marks.idle_ms(run.trace, "forward")
