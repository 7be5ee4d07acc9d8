"""Plain front-end of the VO cells, in PyTorch: strongest-K FAST keypoints,
BRIEF-256 descriptors and mutual-nearest matching with a ratio test.

Written from the front-end's stated semantics:
  * keypoints: FAST SumAbsolute with nonmax (``reference.fast``), the K
    strongest by (score clipped to the bits a packed (score, index) int32 key
    leaves, then row-major position, earlier first); slots past the frame's
    keypoints are invalid;
  * BRIEF: the 256 point pairs drawn from ``numpy.random.default_rng(0x1EAF)``
    (normal, sigma 7.5, rounded, clipped to +-15); bit b of word j (int32) is
    pair 32 j + b: the 5x5 box sum at the first point below that at the
    second.  Box sums replicate outwards from the 2-pixel border; a slot is
    valid where its keypoint is valid and 18 pixels or more from every edge;
  * matching: Hamming distance (XOR and popcount; 257 where either slot is
    invalid), a's best b (the first minimum), b's best a, kept where mutual,
    at most 64 and 10 d < 9 d2 with d2 the second best.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import fast

BITS = 256
WORDS = BITS // 32
PATCH_R = 15
BORDER = PATCH_R + 3


def pattern() -> np.ndarray:
    """(256, 2, 2) int32 (dx, dy) of each pair's two points."""
    rng = np.random.default_rng(0x1EAF)
    pts = rng.normal(0.0, PATCH_R / 2.0, size=(BITS, 2, 2))
    return np.clip(np.round(pts), -PATCH_R, PATCH_R).astype(np.int32)


def strongest(mask: torch.Tensor, score: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xy (K, 2) int32, valid (K,)) of one frame's K strongest keypoints."""
    h, w = mask.shape
    n = h * w
    idx_bits = max(1, (n - 1).bit_length())
    clip = (1 << (31 - idx_bits)) - 1
    s = torch.clamp(score.reshape(n).to(torch.int64), max=clip)
    idx = torch.arange(n, device=mask.device)
    # Larger score first, then the smaller index.
    key = torch.where(mask.reshape(n), s * n + (n - 1 - idx), -1)
    top = torch.topk(key, min(k, n)).values
    valid = top >= 0
    sel = torch.where(valid, n - 1 - top % n, 0)
    xy = torch.stack([sel % w, sel // w], -1).to(torch.int32)
    if k > n:
        xy = torch.cat([xy, xy.new_zeros(k - n, 2)])
        valid = torch.cat([valid, valid.new_zeros(k - n)])
    return xy, valid


def box5(frame: torch.Tensor) -> torch.Tensor:
    """5x5 box sums of one (H, W) u8 frame, int64, each taken at the pixel
    clamped to [2, H-3] x [2, W-3]."""
    h, w = frame.shape
    x = frame.to(torch.int64)
    rows = sum(x[d:h - 4 + d] for d in range(5))  # (H-4, W): centres 2..H-3
    sums = sum(rows[:, d:w - 4 + d] for d in range(5))  # (H-4, W-4)
    yi = (torch.arange(h, device=frame.device) - 2).clamp(0, h - 5)
    xi = (torch.arange(w, device=frame.device) - 2).clamp(0, w - 5)
    return sums[yi][:, xi]


def describe(frame: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(desc (K, 8) int32, desc_valid (K,)) of one frame's keypoints."""
    h, w = frame.shape
    blur = box5(frame)
    x, y = xy[:, 0].long(), xy[:, 1].long()
    ok = valid & (x >= BORDER) & (x < w - BORDER) & (y >= BORDER) & (y < h - BORDER)
    x = torch.where(ok, x, BORDER)
    y = torch.where(ok, y, BORDER)
    pat = torch.as_tensor(pattern(), device=frame.device).long()
    a = blur[y[:, None] + pat[None, :, 0, 1], x[:, None] + pat[None, :, 0, 0]]
    b = blur[y[:, None] + pat[None, :, 1, 1], x[:, None] + pat[None, :, 1, 0]]
    bits = (a < b).to(torch.int64).reshape(-1, WORDS, 32)
    words = (bits << torch.arange(32, device=frame.device)).sum(-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return words, ok


def features(frames: torch.Tensor, threshold: int, count: int, k: int, *, strict: bool = True):
    """(xy (F, K, 2) int32, kp_valid (F, K), desc (F, K, 8) int32, desc_valid
    (F, K)) of an (F, H, W) u8 stack, frame by frame.  ``strict=False``
    breaks FAST's strict threshold (the control)."""
    out = [[], [], [], []]
    for frame in frames:
        mask, score = fast.detect_frame(frame, threshold, count, "sum_absolute", strict=strict)
        xy, valid = strongest(mask, score, k)
        desc, dvalid = describe(frame, xy, valid)
        for lst, v in zip(out, (xy, valid, desc, dvalid)):
            lst.append(v)
    return tuple(torch.stack(v) for v in out)


def _popcount(v: torch.Tensor) -> torch.Tensor:
    v = v & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming(desc_a, valid_a, desc_b, valid_b) -> torch.Tensor:
    """(Ka, Kb) int64 Hamming distances of one pair; 257 where invalid."""
    x = desc_a.to(torch.int64)[:, None, :] ^ desc_b.to(torch.int64)[None, :, :]
    d = _popcount(x).sum(-1)
    bad = ~(valid_a[:, None] & valid_b[None, :])
    return torch.where(bad, BITS + 1, d)


def match(desc_a, valid_a, desc_b, valid_b, max_dist: int = 64) -> torch.Tensor:
    """(Ka,) int64: a's matched slot of b, or -1."""
    d = hamming(desc_a, valid_a, desc_b, valid_b)
    best_b = torch.argmin(d, dim=1)
    best = d.gather(1, best_b[:, None])[:, 0]
    second = d.scatter(1, best_b[:, None], BITS + 1).amin(1)
    best_a = torch.argmin(d, dim=0)
    mutual = best_a[best_b] == torch.arange(d.shape[0], device=d.device)
    ok = mutual & (best <= max_dist) & (best * 10 < second * 9) & valid_a
    return torch.where(ok, best_b, -1)
