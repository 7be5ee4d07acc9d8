"""What a program span costs the host: ns per ``tracing.span`` entered and
left with no profiler on and with one recording (CPU activity), beside a
``torch.profiler.record_function`` range off and on.

    python -m feature_detector_fast_tpu_torch.tools.span_cost [--rounds N] [--spans N]

Prints one JSON record: the best of ``rounds`` rounds of ``spans`` empty
spans each, host clock (``time.perf_counter_ns``).  No device work: the
cost is the host's, whatever the card.
"""

from __future__ import annotations

import argparse
import json
import time
from contextlib import nullcontext
from typing import Callable, Dict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..utils import tracing


def _ns_each(make: Callable, spans: int, rounds: int, recording: bool) -> float:
    best = float("inf")
    for _ in range(rounds):
        tracing.clear()
        with profile(activities=[ProfilerActivity.CPU]) if recording else nullcontext():
            t0 = time.perf_counter_ns()
            for _ in range(spans):
                with make("stage"):
                    pass
            best = min(best, (time.perf_counter_ns() - t0) / spans)
    tracing.clear()
    return best


def run(rounds: int = 5, spans: int = 20000) -> Dict:
    return {"name": "span_cost", "torch": torch.__version__, "spans": spans, "rounds": rounds,
            "span_off_ns": _ns_each(tracing.span, spans, rounds, False),
            "span_on_ns": _ns_each(tracing.span, spans, rounds, True),
            "record_function_off_ns": _ns_each(record_function, spans, rounds, False),
            "record_function_on_ns": _ns_each(record_function, spans, rounds, True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--spans", type=int, default=20000)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.rounds, args.spans)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
