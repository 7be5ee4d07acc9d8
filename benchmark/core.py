"""One run of one cell: set-up, the measured window, the traced sub-window,
the comparison that decides ``correct``, and the result line.

A driver (``drivers/<name>.py``) gives ``make(config, traffic, seed, device,
limits)``, which builds the inputs from the seed and warms up every shape the
traffic uses, and returns an object with:
  * ``frames_per_request``;
  * ``request()``: one closed-loop request, returning once its results are
    in hand on the host; the answer it returns is what may be checked;
  * optionally ``spans``: seconds by name that the driver's own host-clock
    spans and the program's stage timers added up;
  * ``release()``: frees the program's state;
  * ``check(kept)``: the compared numbers, ``[(name, value, limit), ...]``,
    for the answers kept from the window (a seeded reservoir sample);
  * optionally ``roofline_work()``, what a kernel metric's bound counts.
The run is correct where every value is at most its limit.
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import catalog
from .yardstick import trace as trace_lib

#: Top-level module names that must not be loaded in a run: the JAX package
#: and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "feature_detector_fast_tpu")


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: catalog.Cell
    driver: object
    setup_s: float
    #: (issue, done) host-clock seconds of each request of the window.
    requests: List[Tuple[float, float]]
    frames: int
    #: From the window's start to the end of its last request.
    window_s: float
    window_peak_bytes: Optional[int]
    #: The driver's ``spans`` as the window left them.
    spans: Dict[str, float]
    trace: Optional[trace_lib.Trace] = None

    @property
    def latencies_s(self) -> List[float]:
        return [d - i for i, d in self.requests]


def forbidden_modules() -> List[str]:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(driver, seconds: float, device: torch.device, seed: int, keep: int
           ) -> Tuple[List[Tuple[float, float]], List[Tuple[int, object]], float, Optional[int]]:
    """Closed loop, one client: requests until ``seconds`` have passed, each
    answer kept with a seeded reservoir sample of ``keep``.  Returns the
    (issue, done) times, the kept (index, answer) pairs, the seconds to the
    end of the last request and the device's peak bytes over the window."""
    rng = random.Random(seed ^ 0x5EED)
    kept: List[Tuple[int, object]] = []
    times: List[Tuple[float, float]] = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    i = 0
    while True:
        issue = time.perf_counter()
        if issue - t0 >= seconds:
            break
        answer = driver.request()
        times.append((issue, time.perf_counter()))
        if len(kept) < keep:
            kept.append((i, answer))
        else:
            j = rng.randrange(i + 1)
            if j < keep:
                kept[j] = (i, answer)
        i += 1
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return times, kept, times[-1][1] - t0, peak


def traced(driver, requests: int, device: torch.device) -> trace_lib.Trace:
    """``requests`` more requests under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            with torch.profiler.record_function(f"{trace_lib.SPAN_PREFIX}request"):
                driver.request()
        _sync(device)
        window_s = time.perf_counter() - t0
    return trace_lib.collect(prof, requests, requests * driver.frames_per_request, window_s)


def measure(cell: catalog.Cell, *, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float, root: str = catalog.HERE) -> Dict:
    """One run of ``cell``; returns the result line as a dict (with
    ``checks`` last).  ``t_start`` is the host-clock second the process
    started at."""
    make = catalog.driver(cell.traffic, root).make
    log(f"set-up: driver starts at {time.perf_counter() - t_start:.3f} s")
    driver = make(cell.config, cell.traffic, seed, device, cell.limits)
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f}")
    keep = int(cell.traffic.get("check_sample", 16))
    times, kept, window_s, window_peak = window(driver, seconds, device, seed, keep)
    run = Run(cell, driver, setup_s, times, len(times) * driver.frames_per_request, window_s,
              window_peak, dict(getattr(driver, "spans", {})))
    lat = run.latencies_s
    log(f"requests {len(times)} in {window_s:.3f} s; latency samples {len(lat)}, ms at "
        f"p5 {1e3 * quantile(lat, 0.05):.4f} p50 {1e3 * quantile(lat, 0.5):.4f} "
        f"p95 {1e3 * quantile(lat, 0.95):.4f} max {1e3 * max(lat):.4f}; first half "
        f"{1e3 * sum(lat[:len(lat) // 2]) / max(1, len(lat) // 2):.4f} ms a request, second half "
        f"{1e3 * sum(lat[len(lat) // 2:]) / max(1, len(lat) - len(lat) // 2):.4f}")
    if trace:
        run.trace = traced(driver, int(cell.traffic["trace_requests"]), device)
        log(f"traced {run.trace.requests} requests in {run.trace.window_s:.3f} s, "
            f"{len(run.trace.device)} device events")
    peak = None
    if device.type == "cuda":
        peak = max(setup_peak, torch.cuda.max_memory_allocated(device))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = catalog.reader(m["name"], root).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": None, "attempted": len(times), "failed": 0, "metrics": metrics,
              "device": device_record(device, cell.chips, peak)}
    if trace:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    run.trace = None
    del run
    driver.release()
    numbers, result["failed"] = driver.check(kept)
    _sync(device)
    checks = {name: {"value": _finite(v), "limit": float(lim)} for name, v, lim in numbers}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def _finite(v: float) -> float:
    """A compared number as JSON can hold it: a value that is not finite
    (a trajectory that diverged) reads 1e300."""
    v = float(v)
    return v if math.isfinite(v) else 1e300


def device_record(device: torch.device, chips: int, peak: Optional[int]) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(peak)}


def print_result(result: Dict) -> None:
    """The compared numbers as the last lines of stderr; the result as the
    last line of stdout."""
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    log(f"correct {result['correct']}")
    print(json.dumps(result, allow_nan=False), flush=True)


def quantile(values: List[float], q: float) -> float:
    """The nearest-rank ``q`` quantile: the smallest value with at least a
    share ``q`` of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]
