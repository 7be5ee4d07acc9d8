"""Device time of the FAST kernels against their bounds on the card.

Times the four entry points of ``csrc/fast.cu`` at t=16, n=9 in OFF,
MaxThreshold and SumAbsolute: ``fdf_fast_words`` and ``fdf_fast_dense`` on
the 1080p benchmark frame alone (the ``detect`` of one frame), rolled 16
ways (16 frames, 33 MB: the batch fits the 50 MB L2) and 64 ways (133 MB:
it does not), and
``fdf_fast_words_tiles`` / ``fdf_fast_dense_tiles`` over one 1080p frame
in 8 row shards.  Each time is device time by ``_common.loop_ms``: the
calls go straight to the library (``fast_cuda._run``) with their outputs
allocated once, queued behind a device sleep, not folded.  Each record
carries the work this batch's data needs (``_common.fast_work``: pixels,
prefilter candidates, arc-test corners), the call's bound
(``_common.fast_bound``) and the share of it that the kernel reaches.

``--baseline PATH`` names another revision of ``fast.cu`` with the same C
interface (for example the previous commit's, written out with ``git
show``); it is built beside the current one, checked to give the same
words, mask and score, and timed in the same loop, in the order baseline,
current, current, baseline.

    python -m feature_detector_fast_tpu_torch.tools.fast_bench [--device cpu] [--rounds N] [--baseline PATH]

On the CPU the plain version stands in for the kernels (host times, for
the records' structure only).  One JSON object per line on stdout.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..config import Config, NonmaxMode
from ..ops import fast_cuda
from ..parallel import spatial
from . import _common

BATCHES, SHARDS = (1, 16, 64), 8
ROUNDS, REPEATS = 20, 5
THRESHOLD, COUNT = 16, 9


def rolled(frame: np.ndarray, n: int) -> np.ndarray:
    """``n`` distinct frames: ``frame`` rolled 7 rows and 97 columns more
    each (the batch ``chip_smoke.py`` uses)."""
    return np.stack([np.roll(frame, (7 * i, 97 * i), axis=(0, 1)) for i in range(n)])


def _kernel_calls(lib, imgs: torch.Tensor, mode: NonmaxMode, tiles: Optional[tuple] = None
                  ) -> Dict[str, Callable]:
    """Zero-argument launches of the words and dense entry points of
    ``lib`` (the whole-frame ones, or with ``tiles`` = (ext, row0, rows,
    height, width) the row-shard ones) into outputs allocated once here."""
    cfg = Config(THRESHOLD, COUNT, mode)
    if tiles is None:
        src, where, (b, rows, w) = imgs, None, imgs.shape
    else:
        ext, row0, rows, height, w = tiles
        src, where, b = ext, (row0, spatial.HALO, height, w), ext.shape[0]
    words = torch.empty((b, rows, -(-w // 32)), dtype=torch.int32, device=imgs.device)
    mask = torch.empty((b, rows, w), dtype=torch.uint16, device=imgs.device)
    score = torch.empty_like(mask)

    def words_call():
        fast_cuda._run(lib, src, (words,), cfg, where)
        return words

    def dense_call():
        fast_cuda._run(lib, src, (mask, score), cfg, where)
        return mask, score

    return {"words": words_call, "dense": dense_call}


def _plain_calls(imgs: torch.Tensor, mode: NonmaxMode, tiles: Optional[tuple] = None
                 ) -> Dict[str, Callable]:
    """The wrappers' CPU path, standing in for the kernels off the card."""
    if tiles is None:
        return {"words": lambda: fast_cuda.detect_words(imgs, THRESHOLD, COUNT, mode),
                "dense": lambda: fast_cuda.detect_dense(imgs, THRESHOLD, COUNT, mode)}
    ext, row0, _, height, w = tiles
    kw = dict(height=height, width=w, halo=spatial.HALO)
    return {"words": lambda: fast_cuda.detect_words_tiles(ext, row0, THRESHOLD, COUNT, mode, **kw),
            "dense": lambda: fast_cuda.detect_dense_tiles(ext, row0, THRESHOLD, COUNT, mode, **kw)}


def run(*, device="cuda", rounds: int = ROUNDS, repeats: int = REPEATS,
        frame: np.ndarray = None, batches=BATCHES, shards: int = SHARDS,
        baseline: Optional[str] = None) -> Iterator[dict]:
    dev, card = _common.start(device)
    img = _common.build_1080p_frame() if frame is None else frame
    h, w = img.shape
    on_card = dev.type == "cuda"
    libs = {"current": fast_cuda.load_library() if on_card else None}
    base = _common.baseline_library(fast_cuda, baseline, dev)
    if base is not None:
        libs["baseline"] = base

    rows = spatial.shard_rows(h, shards)
    [(_, ext, row0)] = spatial.shard_slabs(torch.from_numpy(img), [dev] * shards, rows)
    cases = [(f"batch {n}", torch.from_numpy(rolled(img, n)).to(dev), None) for n in batches]
    cases.append((f"{shards} shards", torch.from_numpy(img)[None].to(dev),
                  (ext, row0, rows, h, w)))
    for where, imgs, tiles in cases:
        work = _common.fast_work(imgs, THRESHOLD, COUNT)
        frames, out_rows = (imgs.shape[0], h) if tiles is None else (shards, rows)
        in_bytes = None if tiles is None else ext.numel()
        for mode in NonmaxMode:
            calls = {name: (_kernel_calls(lib, imgs, mode, tiles) if on_card
                            else _plain_calls(imgs, mode, tiles)) for name, lib in libs.items()}
            for form in ("words", "dense"):
                kernel = "fdf_fast_" + form + ("" if tiles is None else "_tiles")
                ms_by = _common.same_loop_ms({name: c[form] for name, c in calls.items()}, dev,
                                             rounds=rounds, repeats=repeats,
                                             what=f"{kernel} {mode.value} on {where}")
                ms = ms_by["current"]
                b = _common.fast_bound(frames, out_rows, w, mode.value, COUNT, work,
                                       words=form == "words", in_bytes=in_bytes)
                rec = {"tool": "fast_bench", "kernel": kernel, "mode": mode.value, "at": where,
                       "frames": frames, "rows": out_rows, "width": w, "threshold": THRESHOLD,
                       "count": COUNT, **work, "ms": ms, **b,
                       "share_of_bound": b["bound_ms"] / ms, "rounds": rounds, "device": card}
                if "baseline" in ms_by:
                    rec["baseline_ms"] = ms_by["baseline"]
                    rec["speedup"] = rec["baseline_ms"] / ms
                _common.log(f"{kernel} {mode.value} {where}: {ms:.5f} ms, bound "
                            f"{b['bound_ms']:.5f} ({b['bound_by']})"
                            + (f", baseline {rec['baseline_ms']:.5f}" if "baseline_ms" in rec else ""))
                yield rec


def main(argv=None) -> int:
    ap = _common.parser(__doc__, ROUNDS)
    ap.add_argument("--baseline", default=None,
                    help="another revision of fast.cu (same C interface) to time against")
    args = ap.parse_args(argv)
    return _common.print_records(run(device=args.device, rounds=args.rounds,
                                     baseline=args.baseline))


if __name__ == "__main__":
    sys.exit(main())
