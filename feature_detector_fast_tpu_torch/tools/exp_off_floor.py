"""Floor decomposition of the OFF words kernel, on the kernels of ``csrc/exp_off.cu``.

Counterpart of the JAX package's ``tools/exp_off_floor.py``.  On the
1080p frame in a device-resident batch of 64 (133 MB, so the input does not
sit in the 50 MB L2), each stage runs ``rounds`` times between two CUDA
events with every output folded into a device accumulator, and reports ms
per frame (median of ``repeats``):

  xor-floor     the accumulator's own read of the batch: the traffic floor
                of any kernel over it.  PyTorch runs eagerly, so no
                ``imgs ^ z`` pass is needed to keep a round from being
                folded away, and none is timed
  pad-floor     + the pad to the 128-multiple grid the TPU kernels took
  load          fdf_off_floor_load (``pallas-1in``): stage the block's u8
                tile, keep = px & 1, ballot store
  triple        fdf_off_floor_triple at span 128 (``pallas-3in``): three
                tiles 128 rows apart
  prefilter     fdf_off_floor_prefilter (what ``pallas-win`` was meant to
                measure): the 4-px halo staging and the cardinal prefilter
  production    fdf_fast_words OFF

and, last, each floor's share of ``production``.  The floors keep the
32 x 8 block skeleton ``fdf_fast_words`` had when they were written; the
kernel now walks 128-column strips with a prefilter skip, so the shares no
longer split its time into stages.  The JAX tool's
``trivial`` stage (production with a 2-op body, by monkeypatching JAX
internals) has no further counterpart: ``prefilter`` beside ``production``
is that comparison, and ``production - prefilter`` is the arc test.

    python -m feature_detector_fast_tpu_torch.tools.exp_off_floor [--device cpu] [--rounds N]
"""

from __future__ import annotations

import sys
from typing import Iterator

import numpy as np
import torch.nn.functional as F

from ..config import NonmaxMode
from ..ops import exp_off, exp_off_cuda, fast_cuda
from . import _common

BATCH, ROUNDS, REPEATS = 64, 20, 3
THRESHOLD, COUNT = 16, 9


def run(*, device="cuda", rounds: int = ROUNDS, repeats: int = REPEATS, batch: int = BATCH,
        frame: np.ndarray = None) -> Iterator[dict]:
    dev, card = _common.start(device)
    img = _common.build_1080p_frame() if frame is None else frame
    imgs = _common.batch_of(img, batch, dev)
    h, w = img.shape
    pad = (0, -w % exp_off.LANES, 0, -h % exp_off.TILE_H)
    stages = {
        "xor-floor": lambda: imgs,
        "pad-floor": lambda: F.pad(imgs, pad),
        "load": lambda: exp_off_cuda.floor_load(imgs),
        "triple": lambda: exp_off_cuda.floor_triple(imgs, exp_off.TILE_H),
        "prefilter": lambda: exp_off_cuda.floor_prefilter(imgs, THRESHOLD, COUNT),
        "production": lambda: fast_cuda.detect_words(imgs, THRESHOLD, COUNT, NonmaxMode.OFF),
    }
    ms = {}
    for stage, fn in stages.items():
        ms[stage] = _common.loop_ms(fn, dev, rounds=rounds, repeats=repeats) / batch
        _common.log(f"{stage}: {ms[stage]:.5f} ms/frame")
        yield {"tool": "exp_off_floor", "stage": stage, "ms_per_frame": ms[stage],
               "batch": batch, "height": h, "width": w, "rounds": rounds, "device": card}
    yield {"tool": "exp_off_floor", "stage": "shares_of_production",
           **{f"{s}_share": ms[s] / ms["production"] for s in stages if s != "production"},
           "arc_test_share": (ms["production"] - ms["prefilter"]) / ms["production"],
           "device": card}


def main(argv=None) -> int:
    args = _common.parser(__doc__, ROUNDS).parse_args(argv)
    return _common.print_records(run(device=args.device, rounds=args.rounds))


if __name__ == "__main__":
    sys.exit(main())
