"""The port's device marks in a traced stretch, and the step's phases they
bound.

During a capture, ``Trainer.train_step`` launches one of the port's kernels
``tpujob_span_mark_<point>`` on its stream at four points of each step, in
this order: ``fwd`` before the forward, ``bwd`` before the backward,
``opt`` after the backward, ``end`` after the update (``runtime/stepstats.py``
in the port). A mark's start in the device trace is when the stream reached
that point. Marks on one stream run in the order they were launched, so
each two marks next to each other in time bound a phase when their points
say so: ``forward`` [``fwd``, ``bwd``), ``backward`` [``bwd``, ``opt``),
``optimizer`` [``opt``, ``end``), and ``input`` from a step's ``end`` to the
next step's ``fwd`` (n traced steps have n - 1 of those).

A capture can lose its first device operation (seen on the card: the
first step's ``fwd`` mark, in some captures). A lost mark takes the
stretches it bounds with it and leaves the others as they are: a phase
reads from the stretches that remain, and nothing where none does (a
program without marks, a run off the card). No stretch is guessed.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from benchmark.trace import Interval, merge

MARK = "tpujob_span_mark"
POINTS = ("fwd", "bwd", "opt", "end")
PHASES = {"forward": ("fwd", "bwd"), "backward": ("bwd", "opt"),
          "optimizer": ("opt", "end"), "input": ("end", "fwd")}
_POINT = re.compile(MARK + "_(" + "|".join(POINTS) + ")")


def points(trace) -> List[Tuple[str, float]]:
    """(point, start in us) of every mark in the trace, in time order."""
    if trace is None:
        return []
    found = ((_POINT.search(name), s) for name, s, _ in trace.device)
    return sorted(((m.group(1), s) for m, s in found if m), key=lambda p: p[1])


def stretches(trace, phase: str) -> List[Interval]:
    """The [start, end) stretches (us) of ``phase``: each two marks next to
    each other whose points bound it."""
    first, last = PHASES[phase]
    marks = points(trace)
    return [(a, b) for (pa, a), (pb, b) in zip(marks, marks[1:]) if (pa, pb) == (first, last)]


def idle_us(trace, spans: List[Interval]) -> float:
    """The time within ``spans`` that no device operation of any stream
    covers, in us."""
    busy = merge((s, e) for _, s, e in trace.device)
    idle = 0.0
    for a, b in spans:
        covered = sum(max(0.0, min(e, b) - max(s, a)) for s, e in busy if s < b and e > a)
        idle += (b - a) - covered
    return idle


def phase_ms(trace, phase: str) -> Optional[float]:
    """The mean length of ``phase``'s stretches, in ms; None without one."""
    spans = stretches(trace, phase)
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1e3


def idle_ms(trace, phase: str) -> Optional[float]:
    """The mean device idle within ``phase``'s stretches, in ms; None
    without one."""
    spans = stretches(trace, phase)
    if not spans:
        return None
    return idle_us(trace, spans) / len(spans) / 1e3
