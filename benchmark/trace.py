"""What a ``torch.profiler`` trace of the window's last steps holds, reduced to
what the per-layer metrics read.

The interval arithmetic is a copy of the port's ``profile_llama._busy_us``
and ``summarize`` (device busy time is the union of the intervals of every
operation on the device, since streams overlap). Kernel names are classed
by each metric's own list of name parts, passed in as data.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]

COPY_PARTS = ("Memcpy", "Memset")


def has_part(name: str, parts: Sequence[str]) -> bool:
    low = name.lower()
    return any(p.lower() in low for p in parts)


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def union_length(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in merge(intervals))


@dataclasses.dataclass
class Trace:
    """One rank's traced stretch: ``device`` (name, start_us, end_us) of every
    operation on the card, ``host`` the host's operations on the thread that
    ran the steps (the one with the most of them), ``wall_s`` the stretch's
    length on the host's clock (synchronised at both ends) and ``steps`` the
    train steps in it."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    wall_s: float
    steps: int

    @classmethod
    def from_profiler(cls, prof, wall_s: float, steps: int) -> "Trace":
        from torch.autograd import DeviceType

        device, host = [], defaultdict(list)
        for e in prof.events():
            row = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == DeviceType.CUDA:
                device.append(row)
            else:
                host[e.thread].append(row)
        main = max(host.values(), key=len) if host else []
        return cls(device, main, wall_s, steps)

    def busy_s(self) -> float:
        return union_length((s, e) for _, s, e in self.device) / 1e6

    def time_s(self, keep: Callable[[str], bool]) -> float:
        """The summed device time of the operations whose name ``keep``
        accepts (overlaps counted once per operation)."""
        return sum(e - s for n, s, e in self.device if keep(n)) / 1e6

    def exposed_s(self, exposed: Callable[[str], bool], hiding: Callable[[str], bool]) -> float:
        """Device time in which an operation ``exposed`` accepts runs and no
        operation ``hiding`` accepts does."""
        a = [(s, e) for n, s, e in self.device if exposed(n)]
        b = [(s, e) for n, s, e in self.device if hiding(n)]
        return (union_length(a + b) - union_length(b)) / 1e6

    def top_device_ops(self, n: int = 10) -> List[List]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            by_name[name[:120]] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle gaps between its first and last operation,
        summed by the innermost host operation running at each gap's middle
        (``idle`` where none is), the longest first."""
        busy = merge((s, e) for _, s, e in self.device)
        gaps = sorted(((end + start) / 2, start - end)
                      for (_, end), (start, _) in zip(busy, busy[1:]))
        host = sorted(self.host, key=lambda r: (r[1], -r[2]))  # parents first
        by_name: Dict[str, float] = defaultdict(float)
        open_ops: List[Tuple[str, float, float]] = []  # nested: innermost last
        i = 0
        for mid, gap in gaps:
            while i < len(host) and host[i][1] <= mid:
                while open_ops and open_ops[-1][2] <= host[i][1]:
                    open_ops.pop()
                open_ops.append(host[i])
                i += 1
            while open_ops and open_ops[-1][2] <= mid:
                open_ops.pop()
            name = open_ops[-1][0] if open_ops else "idle"
            by_name[name[:120]] += gap / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]
