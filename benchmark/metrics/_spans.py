"""The span metrics' shared reading: the traced sub-window's program spans
(the port's ``utils/tracing``) joined with its device trace
(``yardstick.spans``), once a run, its lines logged to stderr.  None where
the run was not traced or the program records no spans."""

import sys

from benchmark.yardstick import spans as spans_lib

try:
    from feature_detector_fast_tpu_torch.utils.tracing import spans as _records
except ImportError:  # a program without spans
    _records = None


def joined(run):
    if run.trace is None or _records is None:
        return None
    j = getattr(run, "program_spans", None)
    if j is None:
        records = _records()
        j = spans_lib.join(run.trace, records)
        lines = j.lines() + [f"spans: {len(records)} recorded, {records.dropped} dropped"]
        # The cell's stage timers over the traced requests alone (they kept
        # counting after the window), beside the spans of the same stages.
        for key, total in getattr(run.driver, "spans", {}).items():
            stage = j.stages.get("vo." + key[len("stage."):]) if key.startswith("stage.") else None
            if stage is not None:
                lines.append(f"span vo.{key[len('stage.'):]}: {stage.host_ns / 1e9:.6f} s, stage "
                             f"timer over the same requests {total - run.spans.get(key, 0.0):.6f} s")
        for line in lines:
            print(line, file=sys.stderr)
        run.program_spans = j
    return j


def host_s_per_request(run, name):
    """Host seconds of the span ``name`` per traced request."""
    j = joined(run)
    if j is None or name not in j.stages:
        return None
    return j.stages[name].host_ns / 1e9 / run.trace.requests


def idle_pct(run, name):
    """The device-idle share of the span ``name``'s intervals, in percent."""
    j = joined(run)
    if j is None or not run.trace.device or name not in j.stages:
        return None
    s = j.stages[name]
    return 100.0 * s.idle_ns / s.host_ns if s.host_ns else None
