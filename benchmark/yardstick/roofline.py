"""The least time the H100 could take for a kernel's work, frozen with the
benchmark.

Peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W):
  * HBM: 3.35e12 bytes/s, NVIDIA's data sheet;
  * int32 lane-operations: 64 INT32 lanes x 132 SMs x 1.98 GHz = 1.673e13/s.
    The data sheet gives no integer rate for these units: this peak is
    derived from the SM's lane count and the boost clock behind the
    published 67 TFLOP/s of fp32.

A kernel's bound is the larger of its bytes over the HBM peak (each input byte
read once, each output byte written once) and its integer operations over
the integer peak.  The operations of the FAST words kernel are those the
inputs need, counted with the plain detector of ``reference.fast``:
  * the cardinal prefilter at every detectable pixel: 8 compares, 6 adds, 2
    compares against the need and the OR (17);
  * the rest of the arc test where the prefilter passes: 16 bright and 16
    dark compares and 16 for the two wraparound run tests, less the 8
    cardinal compares already made (40);
  * at an arc-test corner, the 3x3 nonmax (9) and the score: MaxThreshold 16
    differences, 2 x 16 3-input min/max for the windows of 3 and 2 x 16 for
    those of 9, 2 x 16 more for two overlapping 9s where count > 9, 2 x 8
    for the max and min over the 16 starts, 2 absolutes and the min (99
    at count 9); SumAbsolute 2 x 16 differences, 2 x 16 add-then-max and
    the max (65).
These counts were written for the program's ``csrc/fast.cu`` as it stood
when the benchmark was defined; they are kept as the work these inputs
need, whatever a later kernel issues.
"""

from __future__ import annotations

import torch

from ..reference import fast as ref_fast

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 64 * 132 * 1.98e9

FAST_PREFILTER_OPS = 17
FAST_ARC_OPS = 48
FAST_CARDINAL_COMPARES = 8
FAST_NONMAX_OPS = 9


def fast_score_ops(mode: str, count: int) -> int:
    if mode == "max_threshold":
        return 16 + 64 + (32 if count > 9 else 0) + 16 + 3
    return {"off": 0, "sum_absolute": 65}[mode]


def fast_work(frames: torch.Tensor, threshold: int, count: int) -> dict:
    """Detectable pixels, prefilter candidates and arc-test corners of a
    (B, H, W) u8 batch, frame by frame."""
    b, h, w = frames.shape
    candidates = corners = 0
    for frame in frames:
        candidates += int(ref_fast.prefilter_mask(frame, threshold, count).sum())
        corners += int(ref_fast.corner_mask(frame, threshold, count).sum())
    return {"pixels": b * max(h - 6, 0) * max(w - 6, 0), "candidates": candidates,
            "corners": corners}


def bound(nbytes: float, int_ops: float) -> dict:
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = int_ops / INT_OPS_PER_S
    return {"bound_s": max(bytes_s, ops_s), "bound_by": "bytes" if bytes_s >= ops_s else "ops",
            "bytes": int(nbytes), "int_ops": int(int_ops)}


def fast_words_bound(frames: int, height: int, width: int, mode: str, count: int,
                     work: dict) -> dict:
    """One words call over ``frames`` (H, W) u8 frames: the pixels in, one
    int32 word per 32 columns of a row out, the operations above."""
    px = frames * height * width
    out = frames * height * -(-width // 32) * 4
    ops = (work["pixels"] * FAST_PREFILTER_OPS
           + work["candidates"] * (FAST_ARC_OPS - FAST_CARDINAL_COMPARES))
    if mode != "off":
        ops += work["corners"] * (FAST_NONMAX_OPS + fast_score_ops(mode, count))
    return bound(px + out, ops)
