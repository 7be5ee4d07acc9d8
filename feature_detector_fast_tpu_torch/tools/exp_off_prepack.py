"""OFF words from a prepacked dual-row plane, against the production words kernel.

Counterpart of the JAX package's ``tools/exp_off_prepack.py``.  The plane
(ops/exp_off.py ``prepack``: per 128-row tile, 72 int32 rows pairing frame
row r with row r + 64 in 16-bit fields) is built outside the kernel, as the
JAX tool builds it in XLA, and ``fdf_fast_words_prepacked`` runs the OFF
arc test on it.  First the words are checked bit-identical to
``fdf_fast_words`` OFF (the tool's own assert; a mismatch raises), then,
on the 1080p frame in a device-resident batch of 64, ms per frame of:

  production          fdf_fast_words OFF
  prepacked           prepack + fdf_fast_words_prepacked (the JAX tool's
                      ``prepacked``: the plane is rebuilt every round)
  prepack             the plain PyTorch prepack alone
  prepacked_kernel    fdf_fast_words_prepacked on a resident plane

and the deltas to production.  The plane is ~2.4x the frame's bytes, so
the question the TPU tool asked -- does moving the window build out of the
kernel pay for the extra traffic? -- is asked again of the H100.  The
prepacked kernel shares production's skeleton and test (128-column strips,
the cardinal prefilter with its warp row skip, the sign-bit ring; exp_off.cu
copies fast.cu's device functions) and reads both 16-bit fields of a tile
from one staging of the plane, so the delta is the cost of prepacking
itself.

``--baseline PATH`` names another revision of ``exp_off.cu`` with the same
C interface; it is built beside the current one, its prepacked words are
checked equal to the current kernel's on the resident plane, and both are
timed as device ms a call (``_common.same_loop_ms``: unfolded, in the order
baseline, current, current, baseline), with production's device ms a call
and the kernel's bound (``_common.words_prepacked_bound``).

    python -m feature_detector_fast_tpu_torch.tools.exp_off_prepack [--device cpu] [--rounds N] [--batch N] [--baseline PATH]
"""

from __future__ import annotations

import sys
from typing import Iterator, Optional

import numpy as np
import torch

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
    plane = exp_off.prepack(imgs)

    def prepacked(p=None):
        return exp_off_cuda.words_prepacked(exp_off.prepack(imgs) if p is None else p,
                                            THRESHOLD, COUNT, height=h, width=w)

    def production():
        return fast_cuda.detect_words(imgs, THRESHOLD, COUNT, NonmaxMode.OFF)

    got, want = prepacked(plane), production()
    if not torch.equal(got, want):
        bad = torch.nonzero(got != want)[:5].tolist()
        raise AssertionError(f"prepacked words != fdf_fast_words OFF at {bad} "
                             f"(of {int((got != want).sum())} words)")
    _common.log("bit-identical vs the production words kernel")
    base = {"tool": "exp_off_prepack", "batch": batch, "height": h, "width": w,
            "threshold": THRESHOLD, "count": COUNT, "rounds": rounds, "device": card}
    yield {**base, "stage": "check", "bit_exact": True,
           "plane_bytes_per_frame": plane[0].numel() * plane.element_size()}
    ms = {}
    for stage, fn in (("production", production), ("prepacked", prepacked),
                      ("prepack", lambda: exp_off.prepack(imgs)),
                      ("prepacked_kernel", lambda: prepacked(plane))):
        ms[stage] = _common.loop_ms(fn, dev, rounds=rounds, repeats=repeats) / batch
        _common.log(f"{stage}: {ms[stage]:.5f} ms/frame")
        yield {**base, "stage": stage, "ms_per_frame": ms[stage]}
    yield {**base, "stage": "delta",
           "production_minus_prepacked_ms": ms["production"] - ms["prepacked"],
           "production_minus_prepacked_kernel_ms": ms["production"] - ms["prepacked_kernel"]}
    if base_lib is None:
        return
    call = _common.same_loop_ms(
        {"current": lambda: prepacked(plane),
         "baseline": lambda: exp_off_cuda._run_prepacked(base_lib, plane, h, w, THRESHOLD,
                                                         COUNT)},
        dev, rounds=rounds, repeats=repeats, what="fdf_fast_words_prepacked")
    prod = _common.same_loop_ms({"current": production}, dev, rounds=rounds, repeats=repeats,
                                what="production")["current"]
    work = _common.fast_work(imgs, THRESHOLD, COUNT)
    b = _common.words_prepacked_bound(plane.numel() * plane.element_size(), batch, h, w, COUNT,
                                      work)
    _common.log(f"fdf_fast_words_prepacked: {call['current']:.5f} ms a call, baseline "
                f"{call['baseline']:.5f}, production {prod:.5f}, bound {b['bound_ms']:.5f}")
    yield {**base, "stage": "prepacked_kernel vs baseline",
           "kernel": "fdf_fast_words_prepacked", "ms": call["current"],
           "baseline_ms": call["baseline"], "speedup": call["baseline"] / call["current"],
           "production_ms": prod, "over_production": call["current"] / prod,
           "baseline_over_production": call["baseline"] / prod, **work, **b,
           "share_of_bound": b["bound_ms"] / call["current"],
           "baseline_share_of_bound": b["bound_ms"] / call["baseline"]}


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
