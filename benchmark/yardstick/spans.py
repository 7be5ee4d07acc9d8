"""The program's own spans joined with a traced sub-window's device events.

The program records its spans while a profiler records, on the clock of the
profiler's events (epoch ns).  Each record has ``id``, ``name``,
``start_ns``, ``end_ns``, ``parent`` (the id of the span open around it on
its thread, or -1) and ``counts``; this module takes any such objects and
imports nothing of the program.  The window is the benchmark's own spans'
extent (``Trace.spans``), stretched to the last device event; records
outside it belong to an earlier window and are left out.

For each span name: its calls, host seconds, self seconds (less its child
spans' seconds), device-idle seconds inside its intervals (the intervals
less ``Trace.busy_intervals()``) and its summed counts; and the window's
device-idle time, and the part of it that no span covers.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[int, int]


@dataclasses.dataclass
class Stage:
    calls: int = 0
    host_ns: int = 0
    self_ns: int = 0
    idle_ns: int = 0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Join:
    stages: Dict[str, Stage]
    #: Device-idle ns of the window, and of that the ns no span covers.
    idle_ns: int
    idle_outside_ns: int
    window: Interval

    def lines(self) -> List[str]:
        """One line per span name and one for the window, for stderr."""
        out = []
        for name, s in sorted(self.stages.items(), key=lambda kv: -kv[1].host_ns):
            share = 100.0 * s.idle_ns / s.host_ns if s.host_ns else 0.0
            out.append(f"span {name}: calls {s.calls}, host {s.host_ns / 1e9:.6f} s, self "
                       f"{s.self_ns / 1e9:.6f} s, device idle inside {s.idle_ns / 1e9:.6f} s "
                       f"({share:.2f}%)" + (f", counts {s.counts}" if s.counts else ""))
        lo, hi = self.window
        out.append(f"spans: window {(hi - lo) / 1e9:.6f} s, device idle {self.idle_ns / 1e9:.6f}"
                   f" s, of it in no program span {self.idle_outside_ns / 1e9:.6f} s")
        return out


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Cover:
    """Sorted disjoint intervals, asked how much of [s, e] they cover."""

    def __init__(self, merged: Sequence[Interval]):
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.prefix = [0]
        for s, e in merged:
            self.prefix.append(self.prefix[-1] + e - s)

    def within(self, s: int, e: int) -> int:
        i = bisect.bisect_right(self.ends, s)  # first interval ending after s
        j = bisect.bisect_left(self.starts, e)  # first interval starting at or after e
        if i >= j:
            return 0
        return (self.prefix[j] - self.prefix[i] - max(0, s - self.starts[i])
                - max(0, self.ends[j - 1] - e))


def join(trace, records) -> Join:
    """The join of ``records`` with ``trace`` (a ``yardstick.trace.Trace``)."""
    bench = trace.spans
    if bench:
        lo = min(s for _, s, _ in bench)
        hi = max([e for _, _, e in bench] + [e for _, _, e in trace.device])
        records = [r for r in records if lo <= r.start_ns and r.end_ns <= hi]
    elif records:
        lo = min(r.start_ns for r in records)
        hi = max([r.end_ns for r in records] + [e for _, _, e in trace.device])
    else:
        lo = hi = 0
    busy = Cover(trace.busy_intervals())
    child_ns: Dict[int, int] = {}
    for r in records:
        child_ns[r.parent] = child_ns.get(r.parent, 0) + r.end_ns - r.start_ns
    stages: Dict[str, Stage] = {}
    for r in records:
        st = stages.setdefault(r.name, Stage())
        dur = r.end_ns - r.start_ns
        st.calls += 1
        st.host_ns += dur
        st.self_ns += dur - child_ns.get(r.id, 0)
        st.idle_ns += dur - busy.within(r.start_ns, r.end_ns)
        for k, v in r.counts.items():
            st.counts[k] = st.counts.get(k, 0) + v
    covered = merge([(r.start_ns, r.end_ns) for r in records])
    idle_covered = sum(e - s - busy.within(s, e) for s, e in covered)
    idle = hi - lo - busy.within(lo, hi)
    return Join(stages, idle, idle - idle_covered, (lo, hi))
