"""Multi-scale (pyramid) FAST detection and description.

Counterpart of ``feature_detector_fast_tpu.models.pyramid``: dyadic levels
built by 2x2 box averaging, the front-end per level with fixed K slots per
level, descriptors computed on the level image, coordinates reported at
level-0 resolution.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from . import brief


def downsample2(image: torch.Tensor) -> torch.Tensor:
    """2x2 box average with round-half-up of (..., H, W) u8 frames, u8
    (dimensions truncate to even)."""
    h, w = image.shape[-2:]
    he, we = h - h % 2, w - w % 2
    x = image[..., :he, :we].to(torch.int32)
    x = x.reshape(*image.shape[:-2], he // 2, 2, we // 2, 2)
    return ((x.sum(dim=(-3, -1)) + 2) // 4).to(torch.uint8)


def build_pyramid(image: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """[level0 (original), level1 (1/2), ...]; stops early if a level gets
    smaller than the descriptor-safe minimum."""
    levels = [image]
    for _ in range(1, n_levels):
        nxt = downsample2(levels[-1])
        if min(nxt.shape[-2:]) < 2 * brief.BORDER + 8:
            break
        levels.append(nxt)
    return levels


class MultiscaleFeatures(NamedTuple):
    """Per-slot arrays over all levels concatenated (K_total = sum K_l)."""

    xy0: torch.Tensor  # (K, 2) int32 coordinates at level-0 resolution
    xy: torch.Tensor  # (K, 2) int32 coordinates at the native level
    level: torch.Tensor  # (K,) int32
    score: torch.Tensor  # (K,) int32
    desc: torch.Tensor  # (K, WORDS) int32
    valid: torch.Tensor  # (K,) bool


def detect_and_describe_multiscale(
    image, threshold: int, count: int, k_per_level: int, n_levels: int = 4, *,
    device="cuda",
) -> MultiscaleFeatures:
    """FAST + BRIEF over a dyadic pyramid of one (H, W) u8 frame; each level
    contributes up to ``k_per_level`` top-scoring keypoints.  Level-l
    coordinates map to level 0 as x0 = x * 2^l (the top-left convention).
    ``device`` as in :func:`brief.detect_and_describe`."""
    from ..api import _as_images

    levels = build_pyramid(_as_images(image, 2, device), n_levels)
    xs0, xs, lv, sc, ds, va = [], [], [], [], [], []
    for l, img_l in enumerate(levels):
        kps, desc, dvalid = brief.detect_and_describe(
            img_l, threshold, count, k_per_level, device=img_l.device)
        xs.append(kps.xy)
        xs0.append(kps.xy * (1 << l))
        lv.append(torch.full((k_per_level,), l, dtype=torch.int32, device=img_l.device))
        sc.append(kps.score)
        ds.append(desc)
        va.append(kps.valid & dvalid)
    return MultiscaleFeatures(
        xy0=torch.cat(xs0), xy=torch.cat(xs), level=torch.cat(lv),
        score=torch.cat(sc), desc=torch.cat(ds), valid=torch.cat(va))
