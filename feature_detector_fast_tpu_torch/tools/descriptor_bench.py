"""Device time of the two descriptor kernels against their bounds, and the
describe route crossover, on the card.

Times ``fdf_brief_words`` (``csrc/brief.cu``) on the 1080p benchmark frame
alone and rolled 16 ways (``fast_bench.rolled``), and
``fdf_extract_windows`` (``csrc/patch.cu``) at the keypoints of the k=1000
front-end batch (16 frames, SumAbsolute t=16 n=9, top 1000 a frame), as
the plain and the steered route each select them.  Each time is device
time by ``_common.loop_ms`` (``folded=False``): the calls go straight to
the library with their outputs allocated once, queued behind a device
sleep.  Each record carries the call's bound (``_common.brief_words_bound``,
``extract_windows_bound``) and the share of it that the kernel reaches.

Then the crossover that sets ``models.brief._DENSE_K_MIN_1080P``: both
describe routes (``describe_patched``, ``describe_dense``) on 16-frame
batches at each k of ``KS``, ms a batch by CUDA events around the calls as
the front-end makes them.  The dense route's cost grows with the pixels,
the patched route's with k, so the crossover is timed at each frame size of
``SIZES`` (VGA cut from the frame, 4K tiled from it) with ``KS`` scaled by
the pixels, to check that it scales as ``brief._dense_k_min`` assumes.

``--baseline DIR`` names a directory holding another revision of
``brief.cu`` and ``patch.cu`` (for example the previous commit's, written
out with ``git show`` into the gitignored ``_parent/``); both are built
beside the current ones, checked to give the same outputs, and timed in
the same loop, in the order baseline, current, current, baseline.

    python -m feature_detector_fast_tpu_torch.tools.descriptor_bench [--device cpu] [--rounds N] [--baseline DIR]

On the CPU the plain versions stand in for the kernels (host times, for
the records' structure only).  One JSON object per line on stdout.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..config import NonmaxMode
from ..models import brief
from ..ops import brief_cuda, fast_cuda, patch_cuda
from . import _common
from .fast_bench import rolled

BATCHES = (1, 16)
K, BATCH_K = 1000, 16
KS = (1000, 2048, 4096, 6144, 8192, 16384)  # keypoints on a frame of the bench frame's size
SIZES = ((1080, 1920), (480, 640), (2160, 3840))
ROUNDS, REPEATS = 20, 5
THRESHOLD, COUNT = 16, 9


def _brief_call(lib, imgs: torch.Tensor) -> Callable:
    """A zero-argument launch of ``lib``'s ``fdf_brief_words`` into planes
    allocated once; the CPU stands in with the plain version."""
    if lib is None:
        return lambda: brief_cuda.describe_words_plain(imgs)
    b, h, w = imgs.shape
    planes = torch.empty((b, brief.WORDS, h, w), dtype=torch.int32, device=imgs.device)

    def call():
        brief_cuda.run(lib, imgs, planes)
        return planes

    return call


def at_size(frame: np.ndarray, h: int, w: int) -> np.ndarray:
    """An (h, w) frame cut from ``frame`` tiled as often as it needs."""
    reps = (-(-h // frame.shape[0]), -(-w // frame.shape[1]))
    return np.ascontiguousarray(np.tile(frame, reps)[:h, :w])


def _windows_call(lib, imgs: torch.Tensor, xy: torch.Tensor) -> Callable:
    """The same for ``fdf_extract_windows`` at (B, K, 2) int32 ``xy``."""
    if lib is None:
        return lambda: patch_cuda.extract_windows_plain(imgs, xy)
    out = torch.empty((*xy.shape[:2], patch_cuda.PATCH, patch_cuda.PATCH), dtype=torch.int32,
                      device=imgs.device)

    def call():
        patch_cuda._launch(lib.fdf_extract_windows, imgs, xy, out)
        return out

    return call


def _record(kernel: str, at: str, ms: Dict[str, float], b: dict, rounds: int, card: str,
            **extra) -> dict:
    rec = {"tool": "descriptor_bench", "kernel": kernel, "at": at, **extra, "ms": ms["current"],
           **b, "share_of_bound": b["bound_ms"] / ms["current"], "rounds": rounds, "device": card}
    if "baseline" in ms:
        rec["baseline_ms"] = ms["baseline"]
        rec["speedup"] = ms["baseline"] / ms["current"]
        rec["baseline_share_of_bound"] = b["bound_ms"] / ms["baseline"]
    _common.log(f"{kernel} {at}: {rec['ms']:.5f} ms, bound {b['bound_ms']:.5f} ({b['bound_by']})"
                + (f", baseline {rec['baseline_ms']:.5f}" if "baseline_ms" in rec else ""))
    return rec


def run(*, device="cuda", rounds: int = ROUNDS, repeats: int = REPEATS,
        frame: np.ndarray = None, batches=BATCHES, k: int = K, batch_k: int = BATCH_K,
        ks=KS, sizes=SIZES, baseline: Optional[str] = None) -> Iterator[dict]:
    dev, card = _common.start(device)
    img = _common.build_1080p_frame() if frame is None else frame
    h, w = img.shape
    on_card = dev.type == "cuda"
    libs = {"current": (brief_cuda.load_library(), patch_cuda.load_library()) if on_card
            else (None, None)}
    if baseline is not None:
        if not on_card:
            raise ValueError("--baseline needs the card")
        from ..utils import cuda_build

        libs["baseline"] = (brief_cuda.bind(cuda_build.load(os.path.join(baseline, "brief.cu"))),
                            patch_cuda.bind(cuda_build.load(os.path.join(baseline, "patch.cu"))))

    for n in batches:
        imgs = torch.from_numpy(rolled(img, n)).to(dev)
        fns = {name: _brief_call(lib[0], imgs) for name, lib in libs.items()}
        ms = _common.same_loop_ms(fns, dev, rounds=rounds, repeats=repeats,
                                  what=f"fdf_brief_words on {n} frames")
        yield _record("fdf_brief_words", f"batch {n}", ms, _common.brief_words_bound(n, h, w),
                      rounds, card, frames=n, height=h, width=w)

    imgs = torch.from_numpy(rolled(img, batch_k)).to(dev)
    mask, score = fast_cuda.detect_dense(imgs, THRESHOLD, COUNT, NonmaxMode.SUM_ABSOLUTE)
    kps = brief.select_topk(mask, score, k)
    xy = kps.xy.to(torch.int32).contiguous()
    # The plain and the steered route hand the kernel the same top-k
    # keypoints; each is timed as its own record.
    for route in ("patched", "steered"):
        fns = {name: _windows_call(lib[1], imgs, xy) for name, lib in libs.items()}
        ms = _common.same_loop_ms(fns, dev, rounds=rounds, repeats=repeats,
                                  what=f"fdf_extract_windows ({route})")
        yield _record("fdf_extract_windows", f"{batch_k} x {k} keypoints, {route} route", ms,
                      _common.extract_windows_bound(xy.cpu().numpy(), h, w), rounds, card,
                      frames=batch_k, k=k, route=route)

    def time(fn) -> float:
        if on_card:
            return _common.time_cuda(fn)
        return _common.loop_ms(fn, dev, rounds=1, repeats=1, folded=False)

    for hs, ws in sizes:
        imgs_s = torch.from_numpy(rolled(at_size(img, hs, ws), batch_k)).to(dev)
        mask_s, score_s = fast_cuda.detect_dense(imgs_s, THRESHOLD, COUNT,
                                                 NonmaxMode.SUM_ABSOLUTE)
        for kk in ks:
            k_s = round(kk * hs * ws / (h * w))
            kps_k = brief.select_topk(mask_s, score_s, k_s)
            rec = {"tool": "descriptor_bench", "stage": "describe_crossover", "height": hs,
                   "width": ws, "k": k_s, "frames": batch_k,
                   "patched_ms": time(lambda: brief.describe_patched(imgs_s, kps_k)),
                   "dense_ms": time(lambda: brief.describe_dense(imgs_s, kps_k)),
                   "dense_k_min": brief._dense_k_min(hs, ws), "device": card}
            rec["patched_ms_per_frame"] = rec["patched_ms"] / batch_k
            rec["dense_ms_per_frame"] = rec["dense_ms"] / batch_k
            _common.log(f"describe {hs}x{ws} k={k_s}: patched {rec['patched_ms_per_frame']:.4f}, "
                        f"dense {rec['dense_ms_per_frame']:.4f} ms per frame "
                        f"(route switch above {rec['dense_k_min']})")
            yield rec
        del imgs_s, mask_s, score_s


def main(argv=None) -> int:
    ap = _common.parser(__doc__, ROUNDS)
    ap.add_argument("--baseline", default=None,
                    help="a directory holding another revision of brief.cu and patch.cu")
    args = ap.parse_args(argv)
    return _common.print_records(run(device=args.device, rounds=args.rounds,
                                     baseline=args.baseline))


if __name__ == "__main__":
    sys.exit(main())
