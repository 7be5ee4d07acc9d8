"""Dense, branchless FAST detection in plain PyTorch.

Counterpart of ``feature_detector_fast_tpu.ops.fast`` and the plain version
of the CUDA kernel in ``csrc/fast.cu``: the CPU path of every entry point
runs it, the tests hold it against the JAX package, and on the card it is
the kernel's yardstick.  Every function takes an (H, W) frame or a
(B, H, W) batch of u8 frames; all difference math is int32.

Semantics are bit-exact with the reference / OpenCV:
  * bright:  p_circle - c >  t   (strict),
  * dark:    c - p_circle >  t,
  * keypoint iff some circular window of `count` taps is all-bright or
    all-dark (opencv_compat.rs:140-165),
  * detection region x in [3, W-4], y in [3, H-4] (fast_simd.rs:342,368),
  * MaxThreshold score: min(|max_s min_{window}|, |min_s max_{window}|) over
    center-minus-tap differences (opencv_compat.rs:172-209),
  * SumAbsolute score: max(sum of bright excesses, sum of dark excesses)
    over tap-minus-center differences (opencv_compat.rs:278-299),
  * nonmax: a keypoint survives iff its score strictly exceeds the scores of
    all 8 neighbors (non-keypoints score 0), and rows y==3 and y==H-4 are
    dropped after competing (opencv_compat.rs:236-260).

The row rules can be judged in the global rows of a taller frame
(``row_offset``, ``height``): :func:`detect_dense_tiles`, the plain version
of the row-shard kernels, runs each shard's slab that way.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import NonmaxMode
from ..geometry import CIRCLE, RADIUS
from . import windows

_IDT = torch.int32


def circle_taps(image: torch.Tensor) -> List[torch.Tensor]:
    """The 16 circle-tap planes (int32) as statically shifted views.

    ``taps[i][..., y, x] == image[..., y + dy_i, x + dx_i]`` wherever that
    is in-bounds; out-of-bounds positions read zero-padding and are masked
    off downstream by the interior mask.
    """
    h, w = image.shape[-2:]
    r = RADIUS
    padded = F.pad(image.to(_IDT), (r, r, r, r))
    return [
        padded[..., r + dy : r + dy + h, r + dx : r + dx + w]
        for (dx, dy) in CIRCLE
    ]


def _global_rows(h: int, device, row_offset: int, height: Optional[int]):
    """Global row of each of the buffer's ``h`` rows, and the frame height."""
    height = h if height is None else int(height)
    return torch.arange(h, device=device) + int(row_offset), height


def interior_mask(shape: Tuple[int, int], device=None, *, row_offset: int = 0,
                  height: Optional[int] = None) -> torch.Tensor:
    """Boolean (H, W) mask of the detectable region x in [3, W-4], y in [3, H-4].

    Row y of the buffer is global row ``row_offset + y`` of a frame
    ``height`` rows tall (by default the buffer is the frame); a row is
    detectable only if its circle lies inside the buffer (y in [3, H-4])
    and its global row lies in [3, height-4].  A row shard with its
    neighbours' halo rows thus gives the rows of the whole frame."""
    h, w = shape
    r = RADIUS
    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    g, height = _global_rows(h, device, row_offset, height)
    row = (rows >= r) & (rows < h - r) & (g >= r) & (g < height - r)
    col = (cols >= r) & (cols < w - r)
    return row[:, None] & col[None, :]


def _bright_dark(
    center: torch.Tensor, taps: Sequence[torch.Tensor], threshold: int
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-tap strict threshold-exceedance masks (opencv_compat.rs:115-122)."""
    t = int(threshold)
    c = center.to(_IDT)
    bright = [p - c > t for p in taps]
    dark = [c - p > t for p in taps]
    return bright, dark


def detect_mask(image: torch.Tensor, threshold: int, count: int, *,
                row_offset: int = 0, height: Optional[int] = None) -> torch.Tensor:
    """Dense keypoint candidacy mask (no nonmax), bool; ``row_offset`` and
    ``height`` place the buffer in its frame (:func:`interior_mask`)."""
    taps = circle_taps(image)
    bright, dark = _bright_dark(image, taps, threshold)
    is_b = windows.ring_any_window_all(bright, int(count), torch.logical_and, torch.logical_or)
    is_d = windows.ring_any_window_all(dark, int(count), torch.logical_and, torch.logical_or)
    return (is_b | is_d) & interior_mask(image.shape[-2:], image.device,
                                         row_offset=row_offset, height=height)


def score_max_threshold(image: torch.Tensor, count: int) -> torch.Tensor:
    """Dense MaxThreshold (OpenCV) score map, int32 (values fit u16).

    With d_i = center - tap_i over the 16-ring:
    extreme_highest = max_s min(window of `count` at s),
    extreme_lowest  = min_s max(window of `count` at s),
    score = min(|extreme_highest|, |extreme_lowest|).
    """
    taps = circle_taps(image)
    c = image.to(_IDT)
    diffs = [c - p for p in taps]
    eh = windows.ring_max_of_window_min(diffs, int(count), torch.minimum, torch.maximum)
    el = windows.ring_min_of_window_max(diffs, int(count), torch.minimum, torch.maximum)
    return torch.minimum(eh.abs(), el.abs())


def score_sum_abs(image: torch.Tensor, threshold: int) -> torch.Tensor:
    """Dense SumAbsolute (paper eq. 3) score map, int32 (values fit u16).

    With d_i = tap_i - center (the opposite sign to MaxThreshold's):
    score = max( sum_{d_i > t} (d_i - t), sum_{-d_i > t} (-d_i - t) ).
    """
    t = int(threshold)
    taps = circle_taps(image)
    c = image.to(_IDT)
    sum_light = torch.zeros_like(c)
    sum_dark = torch.zeros_like(c)
    for p in taps:
        d = p - c
        sum_light += torch.where(d > t, d - t, 0)
        sum_dark += torch.where(-d > t, -d - t, 0)
    return torch.maximum(sum_light, sum_dark)


def nonmax_mask(kp: torch.Tensor, score: torch.Tensor, *, row_offset: int = 0,
                height: Optional[int] = None) -> torch.Tensor:
    """3x3 strict-maximum suppression on a keypoint-masked score map.

    A keypoint survives iff score > every 8-neighbor score, where
    non-keypoints contribute 0.  The global rows 3 and height-4 (the
    buffer's rows 3 and H-4 by default; see :func:`interior_mask`) take
    part as neighbors but are themselves dropped.  The roll's wraparound
    only carries rows/cols of the buffer's zero-score 3-pixel border, so
    it cannot affect the result.
    """
    s = torch.where(kp, score.to(_IDT), 0)
    neigh = torch.full_like(s, -1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            neigh = torch.maximum(neigh, torch.roll(s, (-dy, -dx), dims=(-2, -1)))
    keep = kp & (s > neigh)
    g, height = _global_rows(kp.shape[-2], kp.device, row_offset, height)
    keep_row = (g != RADIUS) & (g != height - RADIUS - 1)
    return keep & keep_row[:, None]


def detect_dense(
    image: torch.Tensor, threshold: int, count: int, nonmax: NonmaxMode, *,
    row_offset: int = 0, height: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full dense pipeline: (final keypoint mask bool, score map u16).

    With nonmax OFF the score map is all zeros and the mask is the arc
    mask; otherwise the score is the selected dense score masked by
    candidacy (before nonmax), and the mask is post-suppression.  Row y of
    the buffer is global row ``row_offset + y`` of a frame ``height`` rows
    tall, and every border rule is judged in global rows
    (:func:`interior_mask`); the defaults make the buffer the frame.
    """
    nonmax = NonmaxMode(nonmax)
    where = dict(row_offset=row_offset, height=height)
    kp = detect_mask(image, threshold, count, **where)
    if nonmax is NonmaxMode.OFF:
        return kp, torch.zeros(image.shape, dtype=torch.uint16, device=image.device)
    if nonmax is NonmaxMode.MAX_THRESHOLD:
        score = score_max_threshold(image, count)
    else:
        score = score_sum_abs(image, threshold)
    score = torch.where(kp, score, 0)
    return nonmax_mask(kp, score, **where), score.to(torch.uint16)


def detect_dense_tiles(
    ext: torch.Tensor, row0: Sequence[int], threshold: int, count: int,
    nonmax: NonmaxMode, *, height: int, width: int, halo: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the row-shard kernels (``csrc/fast.cu``
    ``fdf_fast_dense_tiles`` / ``fdf_fast_words_tiles``).

    ``ext`` is an (S, rows + 2*halo, >= width) u8 stack of shard slabs:
    shard s's own rows with ``halo`` rows of its neighbours above and
    below; ``row0[s]`` is the global row of its first own row, in a frame
    ``height`` x ``width``.  Returns (mask bool, score u16), (S, rows,
    width): each shard's own rows, equal to those rows of
    :func:`detect_dense` of the whole frame when halo >= 4."""
    rows = ext.shape[-2] - 2 * halo
    masks, scores = [], []
    for slab, r0 in zip(ext, row0):
        mask, score = detect_dense(slab[:, :width], threshold, count, nonmax,
                                   row_offset=int(r0) - halo, height=height)
        masks.append(mask[halo:halo + rows])
        scores.append(score[halo:halo + rows])
    return torch.stack(masks), torch.stack(scores)
