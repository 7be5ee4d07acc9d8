"""Tracing / profiling facilities.

Counterpart of ``feature_detector_fast_tpu.utils.tracing``:

  * ``trace(...)``: host-side trace prints gated by the FDF_TRACE env var
    (cheap no-ops when off),
  * ``profile(log_dir)``: context manager around ``torch.profiler`` that
    writes a Chrome / Perfetto trace JSON of host and device activity into
    ``log_dir``,
  * ``annotate(name)``: a labelled span of the trace
    (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

TRACE_ENV = "FDF_TRACE"


def tracing_enabled() -> bool:
    return os.environ.get(TRACE_ENV, "0") not in ("", "0", "false")


def trace(*args) -> None:
    """Host-side trace print, enabled by FDF_TRACE=1."""
    if tracing_enabled():
        print("[fdf]", *args)


@contextlib.contextmanager
def profile(log_dir: str, *, device="cuda") -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler``: CPU and CUDA activity, or
    the CPU's alone with ``device="cpu"``.  On exit the trace is written to
    ``log_dir/trace_<time>_<pid>.json`` (open it in Perfetto or
    chrome://tracing); the profiler object is yielded, so the caller may
    also read ``key_averages()``.  CUDA activity needs a card: without one
    it raises rather than profile the CPU alone."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to profile the CPU")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}_{os.getpid()}.json"))


def annotate(name: str):
    """Label a code span in profiler traces."""
    return torch.profiler.record_function(name)
