"""Arc-count and threshold sweep: keypoints and ms per frame on the card.

Counterpart of the JAX package's ``tools/sweep.py``: SumAbsolute at
counts 9..=16 (the n >= 12 regime included) and thresholds 16 and 32 on
one frame (the 1080p benchmark frame, or the image given), each point
``rounds`` calls of ``api.detect_batch_device`` on the device-resident
frame, outputs folded into a device accumulator, between two CUDA events.

    python -m feature_detector_fast_tpu_torch.tools.sweep [image.png] [--device cpu] [--rounds N]

One JSON object per line on stdout.
"""

from __future__ import annotations

import sys
from typing import Iterator, Sequence

import numpy as np
import torch

from .. import api
from ..config import Config, NonmaxMode
from ..utils.image import load_luma8
from . import _common

ROUNDS = 10


def run(*, device="cuda", rounds: int = ROUNDS, repeats: int = 3, frame: np.ndarray = None,
        counts: Sequence[int] = range(9, 17),
        thresholds: Sequence[int] = (16, 32)) -> Iterator[dict]:
    dev, card = _common.start(device)
    img = _common.build_1080p_frame() if frame is None else frame
    imgs = torch.from_numpy(np.ascontiguousarray(img))[None].to(dev)
    for count in counts:
        for threshold in thresholds:
            cfg = Config(threshold, count, NonmaxMode.SUM_ABSOLUTE)
            n = int(api.detect_batch_device(imgs, cfg, device=dev)[1][0])
            ms = _common.loop_ms(lambda: api.detect_batch_device(imgs, cfg, device=dev), dev,
                                 rounds=rounds, repeats=repeats)
            yield {"threshold": threshold, "count": count, "nonmax": "sum_absolute",
                   "keypoints": n, "ms_per_frame": ms, "device": card}


def main(argv=None) -> int:
    ap = _common.parser(__doc__, ROUNDS)
    ap.add_argument("image", nargs="?", default=None, help="a frame (default: the 1080p frame)")
    args = ap.parse_args(argv)
    frame = load_luma8(args.image) if args.image else None
    return _common.print_records(run(device=args.device, rounds=args.rounds, frame=frame))


if __name__ == "__main__":
    sys.exit(main())
