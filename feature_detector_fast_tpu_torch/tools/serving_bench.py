"""The pipelined detection serving path on the card: single-shot against depths 1, 2 and 4.

Counterpart of the JAX package's ``tools/serving_bench.py``.  Per config
(OFF, MaxThreshold, SumAbsolute at t=16, n=9) it streams (16, 1080, 1920)
host batches through ``serving.DetectorPipeline``:

  * single-shot: depth 0 (each batch drained right after its submit), 4
    batches;
  * pipelined: depths 1, 2 and 4 over ``rounds`` batches;

and checks every streamed frame's keypoints bit-identical to
``api.detect_arrays`` of the frame, at every depth (``bit_exact``; a
mismatch raises).  The submit / ready split of each stream's host time
shows where a deeper pipeline queues its copies.

First it measures the PCIe link the frames cross: host-to-device MB/s from
pageable and from pinned memory and device-to-host MB/s for a 33 MB batch
(medians of 3), and the round trip of a one-element op.  The JAX tool's
``grown_cap`` has no counterpart: the port has no compaction cap.

    python -m feature_detector_fast_tpu_torch.tools.serving_bench [--device cpu] [--rounds N]

One JSON object per line on stdout; diagnostics on stderr.
"""

from __future__ import annotations

import sys
import time
from typing import Iterator, Optional

import numpy as np
import torch

from .. import api
from ..config import Config, NonmaxMode
from ..serving import DetectorPipeline
from . import _common

BATCH = 16
ROUNDS = 12  # batches per pipelined stream
SINGLE_SHOT_BATCHES = 4
CONFIGS = tuple((m.value, Config(16, 9, m)) for m in NonmaxMode)


def _median_s(fn, n: int) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def measure_link(dev: torch.device, batch_np: np.ndarray) -> dict:
    """PCIe link between host and card: MB/s of ``batch_np`` to the card
    from pageable and from pinned memory and back, and the round trip of a
    one-element op; medians of 3 (7 for the round trip)."""
    one = torch.ones((), dtype=torch.int32, device=dev)
    rtt = _median_s(lambda: int(one + 1), 7)
    pageable = torch.from_numpy(batch_np)
    pinned = torch.empty(batch_np.shape, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(pageable)
    on_dev = pageable.to(dev)

    def h2d(src):
        src.to(dev, non_blocking=True)
        torch.cuda.synchronize(dev)

    mb = batch_np.nbytes / 1e6
    return {"rtt_ms": rtt * 1e3,
            "h2d_pageable_MBps": mb / _median_s(lambda: h2d(pageable), 3),
            "h2d_pinned_MBps": mb / _median_s(lambda: h2d(pinned), 3),
            "d2h_MBps": mb / _median_s(lambda: on_dev.cpu(), 3),
            "bytes": batch_np.nbytes}


def run_stream(batch_np: np.ndarray, config: Config, depth: int, n_batches: int,
               expect_xy: Optional[np.ndarray], device):
    """Stream ``n_batches`` copies of ``batch_np`` through a
    DetectorPipeline; returns (s per frame, keypoints per frame, submit s,
    ready/drain s).  With ``expect_xy`` every frame's keypoints must equal
    it."""
    pipe = DetectorPipeline(config, depth=depth, device=device)
    got, t_submit, t_ready = [], 0.0, 0.0
    t0 = time.perf_counter()
    for _ in range(n_batches):
        t = time.perf_counter()
        pipe.submit(batch_np)
        t_submit += time.perf_counter() - t
        t = time.perf_counter()
        got.extend(pipe.ready())
        t_ready += time.perf_counter() - t
    t = time.perf_counter()
    got.extend(pipe.drain())
    t_ready += time.perf_counter() - t
    dt = time.perf_counter() - t0
    n_frames = sum(len(kps) for kps in got)
    if n_frames != n_batches * batch_np.shape[0]:
        raise AssertionError(f"the pipeline returned {n_frames} frames of "
                             f"{n_batches * batch_np.shape[0]}")
    if expect_xy is not None:
        for kps in got:
            for xy in kps:
                if not np.array_equal(xy, expect_xy):
                    raise AssertionError(f"pipelined keypoints diverge at depth {depth}: "
                                         f"{len(xy)} vs {len(expect_xy)} expected")
    return dt / n_frames, len(got[-1][0]), t_submit, t_ready


def run(*, device="cuda", rounds: int = ROUNDS, batch: int = BATCH,
        frame: np.ndarray = None) -> Iterator[dict]:
    dev, card = _common.start(device)
    img = _common.build_1080p_frame() if frame is None else frame
    batch_np = np.broadcast_to(img, (batch,) + img.shape).copy()
    if dev.type == "cuda":
        link = measure_link(dev, batch_np)
        _common.log(f"link: {link}")
    else:
        link = {"note": "no card: the link is not measured"}
    yield {"stage": "pcie_link", **link, "device": card}

    for name, config in CONFIGS:
        expect = api.detect_arrays(img, config, device=dev)
        sec0, n_kp, sub0, rdy0 = run_stream(batch_np, config, 0, SINGLE_SHOT_BATCHES, expect, dev)
        rec = {"stage": "serving", "config": name, "keypoints": n_kp, "bit_exact": True,
               "batch": batch, "single_shot_ms_per_frame": sec0 * 1e3,
               "single_shot_fps": 1.0 / sec0, "single_shot_submit_s": sub0,
               "single_shot_ready_s": rdy0}
        for depth in (1, 2, 4):
            sec, _, sub, rdy = run_stream(batch_np, config, depth, rounds, expect, dev)
            rec[f"depth{depth}_ms_per_frame"] = sec * 1e3
            rec[f"depth{depth}_fps"] = 1.0 / sec
            rec[f"depth{depth}_submit_s"] = sub
            rec[f"depth{depth}_ready_s"] = rdy
        rec["pipeline_speedup"] = rec["single_shot_ms_per_frame"] / rec["depth2_ms_per_frame"]
        rec["device"] = card
        _common.log(f"{name}: single {rec['single_shot_fps']:.1f} f/s -> depth2 "
                    f"{rec['depth2_fps']:.1f} f/s (x{rec['pipeline_speedup']:.2f})")
        yield rec


def main(argv=None) -> int:
    args = _common.parser(__doc__, ROUNDS).parse_args(argv)
    return _common.print_records(run(device=args.device, rounds=args.rounds))


if __name__ == "__main__":
    sys.exit(main())
