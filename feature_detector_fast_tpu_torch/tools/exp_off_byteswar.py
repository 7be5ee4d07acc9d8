"""8-bit-field against 16-bit-field SWAR for the OFF arc phase: the predicate sequences.

Counterpart of the JAX package's ``tools/exp_off_byteswar.py``: the
16-tap dual-polarity predicate sequence in 16-bit fields (2 px a 32-bit
lane, one biased add per compare: ``fdf_swar_pred16``) and in 8-bit fields
(4 px a lane, a bytewise unsigned compare: ``fdf_swar_pred8``), run at an
equal logical pixel count on seeded int32 planes in [0, 2^30): 64 programs'
worth of (256, 128) planes for 16-bit fields, (128, 128) for 8-bit.  Each
sequence runs ``rounds`` times between two CUDA events (``_common.loop_ms``:
queued behind a short device sleep, since a call takes ~0.01-0.02 ms on the
device, less than the host needs to launch it), with the first element of
each output folded into a device accumulator, as the JAX tool folds
``c ^ o[0, 0]``: a sum of the whole output would cost more than the kernel.
Reported are ms per call (median of ``repeats``; the fold's two one-element
kernels included), Gpx/s and the byte / 16-bit time ratio.

    python -m feature_detector_fast_tpu_torch.tools.exp_off_byteswar [--device cpu] [--rounds N]
"""

from __future__ import annotations

import sys
from typing import Iterator

import numpy as np
import torch

from ..ops import exp_off_cuda
from . import _common

ROWS, LANES, GRID = 256, 128, 64
ROUNDS, REPEATS = 8, 5


def run(*, device="cuda", rounds: int = ROUNDS, repeats: int = REPEATS, rows: int = ROWS,
        grid: int = GRID) -> Iterator[dict]:
    dev, card = _common.start(device)
    rng = np.random.default_rng(0)

    def mk(r):
        return torch.from_numpy(rng.integers(0, 2**30, (grid * r, LANES), np.int64)
                                .astype(np.int32)).to(dev)

    out = {}
    for tag, fn, r, px_per_lane in (("seq16", exp_off_cuda.swar_pred16, rows, 2),
                                    ("seq8", exp_off_cuda.swar_pred8, rows // 2, 4)):
        x, a, b = mk(r), mk(r), mk(r)
        ms = _common.loop_ms(lambda: fn(x, a, b)[0, 0], dev, rounds=rounds, repeats=repeats)
        px = grid * r * LANES * px_per_lane
        out[tag] = ms
        _common.log(f"{tag}: {ms:.5f} ms/call ({px / (ms * 1e6):.1f} Gpx/s)")
        yield {"tool": "exp_off_byteswar", "stage": tag, "ms_per_call": ms, "pixels": px,
               "gpx_per_s": px / (ms * 1e6), "plane_shape": [grid * r, LANES],
               "rounds": rounds, "device": card}
    yield {"tool": "exp_off_byteswar", "stage": "ratio",
           "byte_over_16bit_time": out["seq8"] / out["seq16"], "device": card}


def main(argv=None) -> int:
    args = _common.parser(__doc__, ROUNDS).parse_args(argv)
    return _common.print_records(run(device=args.device, rounds=args.rounds))


if __name__ == "__main__":
    sys.exit(main())
