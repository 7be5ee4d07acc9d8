"""Plain FAST-9..16 with OpenCV 3.2's semantics, in PyTorch: the yardstick the
detection cells' answers are held to.

Written from the semantics, not from the program: a pixel p at x in [3, W-4],
y in [3, H-4] is a corner when some run of ``count`` consecutive taps of the
16-tap Bresenham circle of radius 3 (clockwise from twelve o'clock) is all
brighter than p + t or all darker than p - t (strict, in integers).  Scores:
MaxThreshold (OpenCV's ``cornerScore``: the largest threshold at which the
corner still passes, as min(|max_s min_window d|, |min_s max_window d|) over
d_i = p - tap_i), SumAbsolute (max of the bright and the dark sums of
|d_i| - t over the taps past the threshold).  Nonmax keeps a corner whose
score is strictly above each of its 8 neighbours' (a non-corner counts 0) and
drops the rows y = 3 and y = H - 4.  Keypoint lists are row-major (y, then x).
Frames go one at a time, so a (16, 1080, 1920) batch needs ~150 MB of
scratch.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: (dx, dy) of the 16 circle taps, clockwise from twelve o'clock.
CIRCLE: Tuple[Tuple[int, int], ...] = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
RADIUS = 3
#: Indices of the four cardinal taps (north, east, south, west).
CARDINAL = (0, 4, 8, 12)


def taps(frame: torch.Tensor) -> List[torch.Tensor]:
    """The 16 tap planes of one (H, W) frame as int32: ``taps[i][y, x] =
    frame[y + dy_i, x + dx_i]`` (0 outside the frame, masked later)."""
    h, w = frame.shape
    p = F.pad(frame.to(torch.int32), (RADIUS,) * 4)
    return [p[RADIUS + dy:RADIUS + dy + h, RADIUS + dx:RADIUS + dx + w] for dx, dy in CIRCLE]


def interior(h: int, w: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    return (((ys >= RADIUS) & (ys < h - RADIUS))[:, None]
            & ((xs >= RADIUS) & (xs < w - RADIUS))[None, :])


def _any_run(flags: List[torch.Tensor], count: int) -> torch.Tensor:
    """Does any circular run of ``count`` taps hold all flags?"""
    out = torch.zeros_like(flags[0])
    for s in range(16):
        run = flags[s].clone()
        for k in range(1, count):
            run &= flags[(s + k) % 16]
        out |= run
    return out


def corner_mask(frame: torch.Tensor, threshold: int, count: int, *,
                strict: bool = True) -> torch.Tensor:
    """The arc test of one (H, W) u8 frame, bool.  ``strict=False`` compares
    with >= instead of >: not OpenCV's rule (the benchmark's control)."""
    t = int(threshold)
    c = frame.to(torch.int32)
    ring = taps(frame)
    if strict:
        bright = [p - c > t for p in ring]
        dark = [c - p > t for p in ring]
    else:
        bright = [p - c >= t for p in ring]
        dark = [c - p >= t for p in ring]
    return (_any_run(bright, count) | _any_run(dark, count)) & interior(*frame.shape, frame.device)


def prefilter_mask(frame: torch.Tensor, threshold: int, count: int) -> torch.Tensor:
    """Pixels of the detectable region that pass the cardinal prefilter: at
    least ``need`` of the 4 cardinal taps bright, or as many dark (need 3
    where count >= 12, else 2: a run of ``count`` covers that many)."""
    t = int(threshold)
    need = 3 if count >= 12 else 2
    c = frame.to(torch.int32)
    ring = taps(frame)
    nb = sum((ring[i] - c > t).to(torch.int32) for i in CARDINAL)
    nd = sum((c - ring[i] > t).to(torch.int32) for i in CARDINAL)
    return ((nb >= need) | (nd >= need)) & interior(*frame.shape, frame.device)


def score_max_threshold(frame: torch.Tensor, count: int) -> torch.Tensor:
    c = frame.to(torch.int32)
    d = [c - p for p in taps(frame)]
    hi = lo = None
    for s in range(16):
        win = [d[(s + k) % 16] for k in range(count)]
        wmin = torch.stack(win).amin(0)
        wmax = torch.stack(win).amax(0)
        hi = wmin if hi is None else torch.maximum(hi, wmin)
        lo = wmax if lo is None else torch.minimum(lo, wmax)
    return torch.minimum(hi.abs(), lo.abs())


def score_sum_abs(frame: torch.Tensor, threshold: int) -> torch.Tensor:
    t = int(threshold)
    c = frame.to(torch.int32)
    light = torch.zeros_like(c)
    dark = torch.zeros_like(c)
    for p in taps(frame):
        d = p - c
        light += torch.where(d > t, d - t, 0)
        dark += torch.where(-d > t, -d - t, 0)
    return torch.maximum(light, dark)


def nonmax(corners: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """Strict 3x3 maximum of the corner-masked score; rows 3 and H-4 dropped."""
    h, w = corners.shape
    s = F.pad(torch.where(corners, score, 0), (1, 1, 1, 1))
    keep = corners.clone()
    centre = s[1:h + 1, 1:w + 1]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx or dy:
                keep &= centre > s[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx]
    keep[RADIUS] = False
    keep[h - RADIUS - 1] = False
    return keep


def detect_frame(frame: torch.Tensor, threshold: int, count: int, nonmax_mode: str, *,
                 strict: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keypoint mask, corner-masked score) of one (H, W) u8 frame under
    ``nonmax_mode`` ("off", "max_threshold" or "sum_absolute")."""
    corners = corner_mask(frame, threshold, count, strict=strict)
    if nonmax_mode == "off":
        return corners, torch.zeros_like(frame, dtype=torch.int32)
    if nonmax_mode == "max_threshold":
        score = score_max_threshold(frame, count)
    elif nonmax_mode == "sum_absolute":
        score = score_sum_abs(frame, threshold)
    else:
        raise ValueError(f"unknown nonmax mode {nonmax_mode!r}")
    score = torch.where(corners, score, 0)
    return nonmax(corners, score), score


def keypoints(frame: torch.Tensor, threshold: int, count: int, nonmax_mode: str, *,
              strict: bool = True) -> np.ndarray:
    """Row-major (N, 2) uint32 (x, y) keypoints of one (H, W) u8 frame."""
    mask, _ = detect_frame(frame, threshold, count, nonmax_mode, strict=strict)
    yx = torch.nonzero(mask)
    return yx[:, [1, 0]].to(torch.int64).cpu().numpy().astype(np.uint32)


def words_to_lists(words: torch.Tensor) -> List[np.ndarray]:
    """Decode (B, H, ceil(W/32)) int32 words (bit b of word j of row y is
    pixel x = 32 j + b) to per-frame row-major (N, 2) uint32 (x, y) arrays."""
    b, h, nw = words.shape
    bits = (words.to(torch.int64)[..., None] >> torch.arange(32, device=words.device)) & 1
    mask = bits.reshape(b, h, nw * 32).bool()
    out = []
    for f in range(b):
        yx = torch.nonzero(mask[f])
        out.append(yx[:, [1, 0]].cpu().numpy().astype(np.uint32))
    return out


def list_mismatch(got: np.ndarray, want: np.ndarray) -> int:
    """Keypoints in one list and not the other, plus one where both hold the
    same set in another order (a row-major list is the contract)."""
    got = np.asarray(got, np.int64).reshape(-1, 2)
    want = np.asarray(want, np.int64).reshape(-1, 2)
    if got.shape == want.shape and np.array_equal(got, want):
        return 0
    key = lambda a: a[:, 1] * (1 << 20) + a[:, 0]  # noqa: E731
    g, w = set(key(got).tolist()), set(key(want).tolist())
    return max(len(g ^ w), 1)
