"""Milliseconds per traced step from the port's ``opt`` device mark to its
``end`` mark (``benchmark/marks.py``): the stream's time in the optimizer
phase of ``Trainer.train_step`` (the clip's norm and scale, the AdamW update
over every parameter, and ``trainer.balance``, the expert biases' step),
idle included; the part of ``elementwise_ms.afmoe`` that is the
optimizer's."""

from benchmark import marks


def read(run):
    if run.unit != "tokens":
        return None
    return marks.phase_ms(run.trace, "optimizer")
