"""The share of the traced sub-window's device-idle time that lies in no
span of the program (outside every ``utils/tracing`` span: the caller's own
code, the benchmark's loop), in percent of all its device-idle time."""

from benchmark.metrics import _spans


def read(run):
    j = _spans.joined(run)
    if j is None or not run.trace.device or not j.stages or j.idle_ns <= 0:
        return None
    return 100.0 * j.idle_outside_ns / j.idle_ns
