"""``optimizer_ms.decoder``'s reading in the ResNet cells: the momentum SGD
update (no clip at ``grad_clip_norm`` 0), from the ``opt`` mark to the
``end`` mark, a traced step."""

from benchmark import marks


def read(run):
    if run.unit != "images":
        return None
    return marks.phase_ms(run.trace, "optimizer")
