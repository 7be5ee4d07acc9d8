"""Stage profile of the front-end: where a 1080p k=1000 frame's time goes.

Counterpart of the JAX package's ``tools/exp_frontend_stages.py``: nested
prefixes of one front-end batch (the 1080p benchmark frame, ``batch``
copies, device-resident) are timed on the device (``_common.loop_ms``:
CUDA events around ``rounds`` calls queued behind a device sleep, outputs
not folded), so each stage's cost falls out by subtraction:

    detect       FAST SumAbsolute dense (``fdf_fast_dense``: mask, score)
    +topk        + top-K selection (``brief.select_topk``)
    +extract     + blurred windows (``fdf_extract_windows``)
    +plain       + plain BRIEF from the windows (``describe_patched``)
    +oriented    + moments, orientation bins and steered BRIEF instead

and the dense route at ``dense_k`` (8192, above the 4500 keypoints a 1080p
frame where the front-end switches to it):

    +topk (k=dense_k)    detect + top-K at dense_k
    +dense (k=dense_k)   + every pixel's BRIEF words (``fdf_brief_words``) and the gather
    +plain (k=dense_k)   + the patched route at the same k, for comparison

``delta_ms`` is a stage's ms a frame less its prefix's.  On the CPU the
same calls run their plain versions and the times are host times.

    python -m feature_detector_fast_tpu_torch.tools.exp_frontend_stages [k] [--batch N]
        [--rounds N] [--device cpu]

One JSON object per line on stdout; diagnostics on stderr.
"""

from __future__ import annotations

import sys
from typing import Iterator

import numpy as np

from ..config import NonmaxMode
from ..models import brief
from ..ops import fast_cuda, patch_cuda
from . import _common

ROUNDS = 10
BATCH = 16
DENSE_K = 8192


def run(k: int = 1000, *, device="cuda", batch: int = BATCH, dense_k: int = DENSE_K,
        rounds: int = ROUNDS, repeats: int = 3, frame: np.ndarray = None) -> Iterator[dict]:
    dev, card = _common.start(device)
    img = _common.build_1080p_frame() if frame is None else frame
    imgs = _common.batch_of(img, batch, dev)

    def detect():
        return fast_cuda.detect_dense(imgs, 16, 9, NonmaxMode.SUM_ABSOLUTE)

    def kps(kk: int) -> brief.Keypoints:
        return brief.select_topk(*detect(), kk)

    def topk(kk: int):
        kp = kps(kk)
        return kp.xy, kp.score, kp.valid

    stages = (
        ("detect", None, k, detect),
        ("+topk", "detect", k, lambda: topk(k)),
        ("+extract", "+topk", k, lambda: patch_cuda.extract_windows_fused(imgs, kps(k).xy)),
        ("+plain", "+extract", k, lambda: brief.describe_patched(imgs, kps(k))),
        ("+oriented", "+extract", k, lambda: brief.describe_patched(imgs, kps(k), oriented=True)),
        (f"+topk (k={dense_k})", "detect", dense_k, lambda: topk(dense_k)),
        (f"+dense (k={dense_k})", f"+topk (k={dense_k})", dense_k,
         lambda: brief.describe_dense(imgs, kps(dense_k))),
        (f"+plain (k={dense_k})", f"+topk (k={dense_k})", dense_k,
         lambda: brief.describe_patched(imgs, kps(dense_k))),
    )
    ms = {}
    for name, prefix, kk, fn in stages:
        ms[name] = _common.loop_ms(fn, dev, rounds=rounds, repeats=repeats, folded=False) / batch
        delta = ms[name] - (ms[prefix] if prefix else 0.0)
        _common.log(f"{name}: {ms[name]:.4f} ms/frame (delta {delta:+.4f} over "
                    f"{prefix or 'nothing'})")
        yield {"stage": name, "k": kk, "ms_per_frame": ms[name], "prefix": prefix,
               "delta_ms": delta, "batch": batch, "shape": list(imgs.shape), "device": card}


def main(argv=None) -> int:
    ap = _common.parser(__doc__, ROUNDS)
    ap.add_argument("k", nargs="?", type=int, default=1000, help="keypoints per frame")
    ap.add_argument("--batch", type=int, default=BATCH, help=f"frames (default {BATCH})")
    args = ap.parse_args(argv)
    return _common.print_records(run(args.k, device=args.device, batch=args.batch,
                                     rounds=args.rounds))


if __name__ == "__main__":
    sys.exit(main())
