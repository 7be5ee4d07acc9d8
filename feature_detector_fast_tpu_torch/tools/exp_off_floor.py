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
  load          fdf_off_floor_load (``pallas-1in``): read the frames once,
                keep = px & 1, store the words
  triple        fdf_off_floor_triple at span 128 (``pallas-3in``): the
                same row of the blocks 128 rows above and below, each byte
                still read once
  prefilter     fdf_off_floor_prefilter (what ``pallas-win`` was meant to
                measure): the 4-px halo staging and the cardinal prefilter
  production    fdf_fast_words OFF

and, last, each floor's share of ``production``.  LOAD and TRIPLE are
streaming kernels: a warp packs 32 words from 16-byte loads (element loads
for other widths and bases), and TRIPLE walks each column of words down the
frame a 128-row block a step, keeping three blocks' words in registers, so
it reads each input byte once; both are device-memory floors of any kernel
over the batch.  PREFILTER shares production's own skeleton (128-column
strips, one column per lane, the same staging and cardinal prefilter,
exp_off.cu copying fast.cu's device functions), so ``production -
prefilter`` is the arc test with its warp row skip, and ``arc_test_share``
its share.  The JAX tool's ``trivial`` stage (production with a 2-op body,
by monkeypatching JAX internals) has no further counterpart: ``prefilter``
beside ``production`` is that comparison.

``--baseline PATH`` names another revision of ``exp_off.cu`` with the same
C interface (for example the previous commit's, written out with ``git
show``).  It is built beside the current one; each floor kernel's words
are checked equal to the baseline's, and both are timed as device ms a
call (``_common.same_loop_ms``: unfolded, in the order baseline, current,
current, baseline), with their bounds and, beside them, production's
device ms a call and the arc-test share from these times.

    python -m feature_detector_fast_tpu_torch.tools.exp_off_floor [--device cpu] [--rounds N] [--batch N] [--baseline PATH]
"""

from __future__ import annotations

import sys
from typing import Iterator, Optional

import numpy as np
import torch.nn.functional as F

from ..config import NonmaxMode
from ..ops import exp_off, exp_off_cuda, fast_cuda
from . import _common

BATCH, ROUNDS, REPEATS = 64, 20, 3
THRESHOLD, COUNT = 16, 9


def run(*, device="cuda", rounds: int = ROUNDS, repeats: int = REPEATS, batch: int = BATCH,
        frame: np.ndarray = None, baseline: Optional[str] = None) -> Iterator[dict]:
    dev, card = _common.start(device)
    base_lib = _common.baseline_library(exp_off_cuda, baseline, dev)
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
    if base_lib is None:
        return
    # The floor kernels against the baseline build's, each with its own C
    # arguments, then production, all as device ms a call.
    c_args = {exp_off.LOAD: (), exp_off.TRIPLE: (exp_off.TILE_H,),
              exp_off.PREFILTER: (THRESHOLD, exp_off.need_for(COUNT))}
    call = {}
    for stage, args in c_args.items():
        kernel = f"fdf_off_floor_{stage}"
        call[stage] = _common.same_loop_ms(
            {"current": stages[stage],
             "baseline": lambda stage=stage, args=args: exp_off_cuda._run_floor(
                 base_lib, stage, imgs, *args)},
            dev, rounds=rounds, repeats=repeats, what=kernel)
        b = _common.floor_bound(stage, batch, h, w)
        _common.log(f"{kernel}: {call[stage]['current']:.5f} ms a call, baseline "
                    f"{call[stage]['baseline']:.5f}, bound {b['bound_ms']:.5f}")
        yield {"tool": "exp_off_floor", "stage": f"{stage} vs baseline", "kernel": kernel,
               "batch": batch, "height": h, "width": w, "ms": call[stage]["current"],
               "baseline_ms": call[stage]["baseline"],
               "speedup": call[stage]["baseline"] / call[stage]["current"], **b,
               "share_of_bound": b["bound_ms"] / call[stage]["current"],
               "baseline_share_of_bound": b["bound_ms"] / call[stage]["baseline"],
               "rounds": rounds, "device": card}
    prod = _common.same_loop_ms({"current": stages["production"]}, dev, rounds=rounds,
                                repeats=repeats, what="production")["current"]
    pre = call[exp_off.PREFILTER]
    yield {"tool": "exp_off_floor", "stage": "arc test vs baseline", "batch": batch,
           "production_ms": prod, "prefilter_ms": pre["current"],
           "baseline_prefilter_ms": pre["baseline"],
           "arc_test_share": (prod - pre["current"]) / prod,
           "baseline_arc_test_share": (prod - pre["baseline"]) / prod, "device": card}


def main(argv=None) -> int:
    ap = _common.parser(__doc__, ROUNDS)
    ap.add_argument("--batch", type=int, default=BATCH, help=f"frames (default {BATCH})")
    ap.add_argument("--baseline", default=None,
                    help="another revision of exp_off.cu (same C interface) to time against")
    args = ap.parse_args(argv)
    return _common.print_records(run(device=args.device, rounds=args.rounds, batch=args.batch,
                                     baseline=args.baseline))


if __name__ == "__main__":
    sys.exit(main())
