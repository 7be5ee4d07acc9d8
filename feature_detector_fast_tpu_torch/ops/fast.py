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
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def interior_mask(shape: Tuple[int, int], device=None) -> torch.Tensor:
    """Boolean (H, W) mask of the detectable region x in [3, W-4], y in [3, H-4]."""
    h, w = shape
    r = RADIUS
    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    row = (rows >= r) & (rows < h - r)
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


def detect_mask(image: torch.Tensor, threshold: int, count: int) -> torch.Tensor:
    """Dense keypoint candidacy mask (no nonmax), bool."""
    taps = circle_taps(image)
    bright, dark = _bright_dark(image, taps, threshold)
    is_b = windows.ring_any_window_all(bright, int(count), torch.logical_and, torch.logical_or)
    is_d = windows.ring_any_window_all(dark, int(count), torch.logical_and, torch.logical_or)
    return (is_b | is_d) & interior_mask(image.shape[-2:], image.device)


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


def nonmax_mask(kp: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """3x3 strict-maximum suppression on a keypoint-masked score map.

    A keypoint survives iff score > every 8-neighbor score, where
    non-keypoints contribute 0.  Rows y==3 and y==H-4 take part as
    neighbors but are themselves dropped.  The roll's wraparound only
    carries rows/cols of the zero-score 3-pixel border, so it cannot
    affect the result.
    """
    h = kp.shape[-2]
    s = torch.where(kp, score.to(_IDT), 0)
    neigh = torch.full_like(s, -1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            neigh = torch.maximum(neigh, torch.roll(s, (-dy, -dx), dims=(-2, -1)))
    keep = kp & (s > neigh)
    rows = torch.arange(h, device=kp.device)
    keep_row = (rows != RADIUS) & (rows != h - RADIUS - 1)
    return keep & keep_row[:, None]


def detect_dense(
    image: torch.Tensor, threshold: int, count: int, nonmax: NonmaxMode
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full dense pipeline: (final keypoint mask bool, score map u16).

    With nonmax OFF the score map is all zeros and the mask is the arc
    mask; otherwise the score is the selected dense score masked by
    candidacy (before nonmax), and the mask is post-suppression.
    """
    nonmax = NonmaxMode(nonmax)
    kp = detect_mask(image, threshold, count)
    if nonmax is NonmaxMode.OFF:
        return kp, torch.zeros(image.shape, dtype=torch.uint16, device=image.device)
    if nonmax is NonmaxMode.MAX_THRESHOLD:
        score = score_max_threshold(image, count)
    else:
        score = score_sum_abs(image, threshold)
    score = torch.where(kp, score, 0)
    return nonmax_mask(kp, score), score.to(torch.uint16)
