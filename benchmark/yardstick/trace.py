"""What a traced sub-window says about the device, read from the profiler's
raw events.

The events come from ``prof.profiler.kineto_results.events()``: building
``prof.events()``' tree of Python objects takes tens of seconds at the ~10^5
kernels of a bundle adjustment.  Device events are kernels, copies
(``Memcpy ...``) and sets (``Memset ...``).  Busy time is the union of their
intervals, never their sum (two streams can overlap).  The benchmark's own
spans are ``torch.profiler.record_function`` ranges whose names start with
``bench.``; an idle gap is labelled with the innermost one open at its
middle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "bench."


@dataclasses.dataclass
class Trace:
    """Device activity of a traced sub-window of ``requests`` requests
    (``frames`` frames) that lasted ``window_s`` seconds on the host clock."""

    requests: int
    frames: int
    window_s: float
    #: (name, start ns, end ns) of every device event.
    device: List[Tuple[str, int, int]]
    #: (name, start ns, end ns) of every benchmark span.
    spans: List[Tuple[str, int, int]]

    @staticmethod
    def kind(name: str) -> str:
        if name.startswith("Memcpy HtoD"):
            return "htod"
        if name.startswith("Memcpy"):
            return "copy"
        if name.startswith("Memset"):
            return "set"
        return "kernel"

    def seconds(self, pred) -> float:
        """Summed device seconds of the events whose name satisfies ``pred``."""
        return sum(e - s for n, s, e in self.device if pred(n)) / 1e9

    def count(self, pred) -> int:
        return sum(1 for n, _, _ in self.device if pred(n))

    @property
    def kernels(self) -> int:
        return self.count(lambda n: self.kind(n) == "kernel")

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def _label(self, t: int) -> str:
        best: Optional[Tuple[str, int, int]] = None
        for name, s, e in self.spans:
            if s <= t <= e and (best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        return best[0][len(SPAN_PREFIX):] if best else "outside any span"

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest gaps between busy intervals, each with the span
        open at its middle."""
        busy = self.busy_intervals()
        gaps = [(s1 - e0, (e0 + s1) // 2) for (_, e0), (s1, _) in zip(busy, busy[1:])]
        gaps.sort(key=lambda g: -g[0])
        return [[self._label(mid), ns / 1e9] for ns, mid in gaps[:n]]


def collect(prof, requests: int, frames: int, window_s: float) -> Trace:
    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.name().startswith(SPAN_PREFIX):
            # A span also shows on the device's timeline; that copy is no
            # device work.
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append((ev.name(), start, end))
        elif ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((ev.name(), start, end))
    return Trace(requests, frames, window_s, device, spans)
