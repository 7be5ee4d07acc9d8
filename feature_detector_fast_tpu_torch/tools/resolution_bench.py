"""Resolution scaling: sustained FAST frames/s on the card against frame size.

Counterpart of the JAX package's ``tools/resolution_bench.py``: nonmax OFF
(or the mode given) at 480p, 720p, 1080p, 1440p and 4K, each frame tiled
from the 1080p benchmark frame (so its corner statistics hold).  The batch
is ``max(4, round(64 * 1920 * 1080 / px))`` frames, about 130 MP resident
on the device at every size, and each of ``rounds`` rounds runs
``api.detect_batch_device`` on it -- the words kernel and the per-frame
keypoint counts, with no host transfer -- with both outputs folded into a
device accumulator, between two CUDA events.  The JAX tool's compaction
cap and its growth loop have no counterpart: the port's keypoint list is
exact without one.

    python -m feature_detector_fast_tpu_torch.tools.resolution_bench [mode] [--device cpu] [--rounds N]

One JSON object per line on stdout; diagnostics on stderr.
"""

from __future__ import annotations

import sys
from typing import Iterator, Sequence, Tuple

import numpy as np

from .. import api
from ..config import Config, NonmaxMode
from . import _common

RESOLUTIONS = (
    ("480p", 640, 480),
    ("720p", 1280, 720),
    ("1080p", 1920, 1080),
    ("1440p", 2560, 1440),
    ("4k", 3840, 2160),
)
ROUNDS = 10
#: Pixels kept resident on the device: 64 frames of 1080p.
RESIDENT_PX = 64 * _common.PX_1080P


def run(mode=NonmaxMode.OFF, *, device="cuda", rounds: int = ROUNDS, repeats: int = 3,
        frame: np.ndarray = None, resolutions: Sequence[Tuple[str, int, int]] = RESOLUTIONS,
        resident_px: int = RESIDENT_PX) -> Iterator[dict]:
    mode = NonmaxMode(mode)
    dev, card = _common.start(device)
    base = _common.build_1080p_frame() if frame is None else frame
    cfg = Config(16, 9, mode)
    for name, w, h in resolutions:
        px = h * w
        batch = max(4, int(round(resident_px / px)))
        imgs = _common.batch_of(_common.tiled(base, h, w), batch, dev)
        _, n = api.detect_batch_device(imgs, cfg, device=dev)
        n_kp = int(n[0])
        ms = _common.loop_ms(lambda: api.detect_batch_device(imgs, cfg, device=dev), dev,
                             rounds=rounds, repeats=repeats) / batch
        _common.log(f"{name}: {ms:.4f} ms/frame = {1e3 / ms:.0f} f/s "
                    f"({n_kp} keypoints, batch {batch})")
        yield {"resolution": name, "width": w, "height": h, "mode": mode.value,
               "ms_per_frame": ms, "frames_per_sec": 1e3 / ms,
               "megapixels_per_sec": px / (ms * 1e3), "keypoints": n_kp, "batch": batch,
               "device": card}


def main(argv=None) -> int:
    ap = _common.parser(__doc__, ROUNDS)
    ap.add_argument("mode", nargs="?", default=NonmaxMode.OFF.value,
                    choices=[m.value for m in NonmaxMode])
    args = ap.parse_args(argv)
    return _common.print_records(run(args.mode, device=args.device, rounds=args.rounds))


if __name__ == "__main__":
    sys.exit(main())
