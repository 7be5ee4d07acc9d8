"""The SLAM front-end on the card: detect + top-K + BRIEF, with and without matching.

Counterpart of the JAX package's ``tools/frontend_bench.py``: at VGA, 720p
and 1080p (each tiled from the 1080p benchmark frame), plain and steered
BRIEF, ``brief.detect_and_describe_batch`` (SumAbsolute t=16 n=9 -> top-K
-> BRIEF-256) on a device-resident batch of ``max(4, round(32 * 1920 * 1080
/ px))`` frames (scaled down by k / 1024 above k = 1024, as the JAX tool
does), optionally with ``match`` of the consecutive frame pairs.  Each of
``rounds`` rounds folds the keypoints, descriptors, validity and match
indices into a device accumulator, between two CUDA events.

    python -m feature_detector_fast_tpu_torch.tools.frontend_bench [k] [--device cpu] [--rounds N]

One JSON object per line on stdout; diagnostics on stderr.
"""

from __future__ import annotations

import sys
from typing import Iterator, Sequence, Tuple

import numpy as np

from ..models import brief, match
from . import _common

RESOLUTIONS = (("vga", 640, 480), ("720p", 1280, 720), ("1080p", 1920, 1080))
ROUNDS = 10
#: Pixels kept resident on the device: 32 frames of 1080p.
RESIDENT_PX = 32 * _common.PX_1080P


def run(k: int = 1000, *, device="cuda", rounds: int = ROUNDS, repeats: int = 3,
        frame: np.ndarray = None, resolutions: Sequence[Tuple[str, int, int]] = RESOLUTIONS,
        resident_px: int = RESIDENT_PX) -> Iterator[dict]:
    dev, card = _common.start(device)
    base = _common.build_1080p_frame() if frame is None else frame
    for name, w, h in resolutions:
        batch = max(4, int(round(resident_px / (h * w))))
        if k > 1024:
            batch = max(4, batch * 1024 // k)
        imgs = _common.batch_of(_common.tiled(base, h, w), batch, dev)
        for oriented in (False, True):
            for with_match in (False, True):

                def step(oriented=oriented, with_match=with_match):
                    kps, desc, dv = brief.detect_and_describe_batch(imgs, 16, 9, k, oriented,
                                                                    device=dev)
                    if not with_match:
                        return kps.xy, desc, dv
                    m = match.match(desc[:-1], dv[:-1], desc[1:], dv[1:])
                    return kps.xy, desc, dv, m.idx_b

                ms = _common.loop_ms(step, dev, rounds=rounds, repeats=repeats) / batch
                tag = ("oriented-" if oriented else "") + (
                    "detect+describe+match" if with_match else "detect+describe")
                _common.log(f"{name} {tag}: {ms:.4f} ms/frame = {1e3 / ms:.0f} f/s "
                            f"(batch {batch}, k {k})")
                yield {"stage": tag, "resolution": name, "k": k, "ms_per_frame": ms,
                       "frames_per_sec": 1e3 / ms, "batch": batch, "device": card}


def main(argv=None) -> int:
    ap = _common.parser(__doc__, ROUNDS)
    ap.add_argument("k", nargs="?", type=int, default=1000, help="keypoints per frame")
    args = ap.parse_args(argv)
    return _common.print_records(run(args.k, device=args.device, rounds=args.rounds))


if __name__ == "__main__":
    sys.exit(main())
