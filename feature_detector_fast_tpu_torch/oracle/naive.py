"""Scalar per-pixel oracle — the correctness anchor (a copy of
``feature_detector_fast_tpu.oracle.naive``).

A deliberately naive, loop-based transcription of the FAST semantics,
mirroring the reference's `opencv_compat.rs` role: "identical to OpenCV,
very inefficient, exists to be diffed against" (opencv_compat.rs:21-23,233).
Everything fast in this framework is differentially tested against this
module (and this module against cv2's FAST for count=9).

Pure Python + scalar numpy; use on small images / fuzz windows only.  For
large-image differential tests use `oracle.native` (C++ scalar oracle).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import Config, NonmaxMode, Point
from ..geometry import CIRCLE, RADIUS


def detect(image: np.ndarray, threshold: int, count: int) -> List[Point]:
    """Scalar detection (reference: opencv_compat.rs:79-169)."""
    img = np.asarray(image, np.uint8)
    h, w = img.shape
    t = int(threshold)
    n = int(count)
    out: List[Point] = []
    for y in range(RADIUS, h - RADIUS):
        for x in range(RADIUS, w - RADIUS):
            c = int(img[y, x])
            neg = [False] * 16
            pos = [False] * 16
            for i, (dx, dy) in enumerate(CIRCLE):
                d = c - int(img[y + dy, x + dx])
                neg[i] = d < 0 and -d > t
                pos[i] = d > 0 and d > t
            if _has_consecutive(neg, n) or _has_consecutive(pos, n):
                out.append(Point(x, y))
    return out


def _has_consecutive(flags: List[bool], n: int) -> bool:
    """Wraparound consecutive-run predicate: exists a start s whose run of
    leading Trues (cycling) reaches n (opencv_compat.rs:140-165)."""
    ln = len(flags)
    for s in range(ln):
        run = 0
        for i in range(ln):
            if flags[(s + i) % ln]:
                run += 1
            else:
                break
        if run >= n:
            return True
    return False


def score_max_threshold(image: np.ndarray, xy: Tuple[int, int], count: int) -> int:
    """OpenCV's nonmax score: the maximum t for which (x, y) would still be
    a keypoint (reference: opencv_compat.rs:172-209)."""
    img = np.asarray(image, np.uint8)
    x, y = xy
    c = int(img[y, x])
    n = int(count)
    diff = [
        c - int(img[y + CIRCLE[i % 16][1], x + CIRCLE[i % 16][0]]) for i in range(32)
    ]
    extreme_highest = max(min(diff[k : k + n]) for k in range(16))
    extreme_lowest = min(max(diff[k : k + n]) for k in range(16))
    return min(abs(extreme_highest), abs(extreme_lowest))


def score_sum_abs_ring(center: int, ring: List[int], threshold: int) -> int:
    """Paper eq. 3 score from explicit ring values
    (reference: opencv_compat.rs:278-299)."""
    t = int(threshold)
    sum_dark = 0
    sum_light = 0
    for p in ring:
        d = int(center) - int(p)
        if d > 0 and abs(d) > t:
            sum_light += d - t
        if d < 0 and abs(d) > t:
            sum_dark += -d - t
    return max(sum_dark, sum_light)


def score_sum_abs(image: np.ndarray, xy: Tuple[int, int], threshold: int) -> int:
    img = np.asarray(image, np.uint8)
    x, y = xy
    ring = [int(img[y + dy, x + dx]) for (dx, dy) in CIRCLE]
    return score_sum_abs_ring(int(img[y, x]), ring, threshold)


def non_max_suppression(
    image: np.ndarray, keypoints: List[Point], config: Config
) -> List[Point]:
    """Scalar nonmax (reference: opencv_compat.rs:212-262): drop border rows
    y==3 and y==H-4; a keypoint survives iff its score strictly exceeds the
    score of every 8-neighbor that is also a keypoint."""
    if config.nonmax is NonmaxMode.OFF:
        return keypoints
    img = np.asarray(image, np.uint8)
    h = img.shape[0]
    if config.nonmax is NonmaxMode.MAX_THRESHOLD:
        score = lambda p: score_max_threshold(img, p, config.count)
    else:
        score = lambda p: score_sum_abs(img, p, config.threshold)
    kpset = set(keypoints)
    out: List[Point] = []
    for kp in keypoints:
        if kp.y == RADIUS or kp.y == h - RADIUS - 1:
            continue
        cur = score((kp.x, kp.y))
        suppressed = False
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                other = Point(kp.x + dx, kp.y + dy)
                if other not in kpset:
                    continue
                if cur <= score((other.x, other.y)):
                    suppressed = True
                    break
            if suppressed:
                break
        if not suppressed:
            out.append(kp)
    return out


def detector(image: np.ndarray, config: Optional[Config] = None) -> List[Point]:
    """detect + nonmax (reference: opencv_compat.rs:302-306)."""
    config = config or Config()
    kps = detect(image, config.threshold, config.count)
    return non_max_suppression(image, kps, config)
