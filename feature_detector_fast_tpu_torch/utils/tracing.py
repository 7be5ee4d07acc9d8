"""The port's spans and counts, and the profile that exports them.

  * ``span(name)``: a context manager around one stage of the program.
    While a torch profiler records (``torch.profiler.profile``, or
    ``profile`` below), leaving it appends one record to an in-memory
    buffer.  Otherwise it costs one check and hands back a shared handle
    that does nothing: no clock read, no allocation, no
    ``record_function``.  The handle's ``add(counter, n=1)`` puts counts on
    the span, and the handle is false where nothing records, so work that
    only feeds a count can be skipped.
  * ``spans()``: the records since the last ``clear()``, in the order the
    spans ended; ``clear()`` empties the buffer.
  * ``profile(log_dir)``: ``torch.profiler.profile`` over the block, whose
    Chrome / Perfetto trace also holds the block's spans.

A record's times are ``time.time_ns()``: epoch nanoseconds, the clock of
the profiler's own events (kineto's ``start_ns()``), so a span lines up with
the kernels and copies it launched.  Spans are not ``record_function``
ranges: the profiler mirrors those onto the device's timeline, where they
would read as device work, and one costs microseconds with no profiler on.
Span stacks are per thread; the profiler's flag is the process's.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple

import torch
import torch.autograd.profiler as _profiler

#: Records the buffer holds; later ones are counted in ``Spans.dropped``.
LIMIT = 1 << 20


class Span(NamedTuple):
    """One span, as it ended."""

    id: int  # order of entry, process-wide
    name: str
    start_ns: int
    end_ns: int
    parent: int  # id of the span open around it on its thread, or -1
    request: int  # id of the outermost span open on its thread (its own if outermost)
    thread: int
    counts: Dict[str, int]


class Spans(list):
    """The buffer's records, and how many a full buffer turned away."""

    dropped: int = 0


_buffer = Spans()
_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()


class _Off:
    """The handle of every span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def add(self, counter: str, n: int = 1) -> None:
        pass

    def __bool__(self) -> bool:
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "id", "parent", "request", "start_ns", "counts")

    def __init__(self, name: str):
        self.name = name
        self.counts: Dict[str, int] = {}

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else -1
        self.request = stack[0].id if stack else self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _local.stack.pop()
        record = Span(self.id, self.name, self.start_ns, end_ns, self.parent, self.request,
                      threading.get_ident(), self.counts)
        with _lock:
            if len(_buffer) < LIMIT:
                _buffer.append(record)
            else:
                _buffer.dropped += 1
        return None

    def add(self, counter: str, n: int = 1) -> None:
        self.counts[counter] = self.counts.get(counter, 0) + n


def span(name: str):
    """A span of the program named ``name`` (``<layer>.<stage>``), recorded
    while a torch profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def spans() -> Spans:
    """A copy of the buffer: every span that ended since the last
    ``clear()``, with ``dropped``."""
    with _lock:
        out = Spans(_buffer)
        out.dropped = _buffer.dropped
    return out


def clear() -> None:
    with _lock:
        _buffer.clear()
        _buffer.dropped = 0


def _chrome_events(records: List[Span], base_ns: int) -> List[dict]:
    """The spans as complete events on a track of their own, in
    microseconds from the trace's ``base_ns``."""
    pid = "program spans"
    events = [{"ph": "M", "name": "process_name", "pid": pid, "args": {"name": pid}}]
    for r in records:
        events.append({"ph": "X", "cat": "fdf_span", "name": r.name, "pid": pid,
                       "tid": r.thread, "ts": (r.start_ns - base_ns) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": {"id": r.id, "parent": r.parent, "request": r.request,
                                **r.counts}})
    return events


@contextlib.contextmanager
def profile(log_dir: str, *, device="cuda") -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler``: CPU and CUDA activity, or
    the CPU's alone with ``device="cpu"``.  The span buffer is cleared on
    entry.  On exit the trace is written to
    ``log_dir/trace_<time>_<pid>.json`` (open it in Perfetto or
    chrome://tracing) with the block's spans on a track of their own; the
    profiler object is yielded, so the caller may also read
    ``key_averages()``, and ``spans()`` holds the block's spans after it.
    CUDA activity needs a card: without one it raises rather than profile
    the CPU alone."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to profile the CPU")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{time.time_ns()}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    # Kineto writes microseconds after ``baseTimeNanoseconds`` (epoch ns).
    trace["traceEvents"] += _chrome_events(spans(), int(trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)
