"""Binary descriptor matching: Hamming distances as one +-1 matrix product.

Counterpart of ``feature_detector_fast_tpu.models.match``.  With
descriptors as +-1 vectors, dot(a, b) = BITS - 2 * hamming(a, b), so the
whole distance matrix is one float32 matmul.  It is exact: the entries are
0 or +-1 and |dot| <= 256, so every partial sum is an integer a float32
holds (under TF32 too, whose 10-bit mantissa holds +-1 exactly).

Policy: mutual nearest neighbours with an integer Lowe ratio test, over
fixed-capacity slots with validity bits.  Every function takes any leading
batch shape: ``(..., K, WORDS)`` descriptors give ``(..., K)`` matches.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .brief import BITS


class Matches(NamedTuple):
    """For each slot of image A, the matched slot of image B (or -1)."""

    idx_b: torch.Tensor  # (..., K) int32, -1 where unmatched
    dist: torch.Tensor  # (..., K) int32 Hamming distance (BITS+1 where unmatched)


def unpack_pm1(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., K, WORDS) int32 -> (..., K, BITS) float32 in {-1, +1}, 0 rows
    where invalid."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc.to(torch.int32)[..., None] >> shifts) & 1  # arithmetic shift; &1 keeps the bit
    pm1 = bits.reshape(*desc.shape[:-1], BITS).to(torch.float32) * 2 - 1
    return torch.where(valid[..., None], pm1, 0.0)


def hamming_matrix(desc_a: torch.Tensor, valid_a: torch.Tensor,
                   desc_b: torch.Tensor, valid_b: torch.Tensor) -> torch.Tensor:
    """(..., Ka, Kb) int32 Hamming distances; invalid rows/cols read BITS + 1."""
    a = unpack_pm1(desc_a, valid_a)
    b = unpack_pm1(desc_b, valid_b)
    dot = torch.matmul(a, b.transpose(-1, -2))
    dist = ((BITS - dot) / 2).to(torch.int32)
    bad = ~(valid_a[..., :, None] & valid_b[..., None, :])
    return torch.where(bad, BITS + 1, dist)


def match(desc_a: torch.Tensor, valid_a: torch.Tensor, desc_b: torch.Tensor,
          valid_b: torch.Tensor, max_dist: int = 64, ratio_num: int = 9,
          ratio_den: int = 10) -> Matches:
    """Mutual-nearest matching with ratio test.

    Slot a matches b iff b = argmin_b' d(a, b'), a = argmin_a' d(a', b)
    (argmin takes the first minimum, as ``jnp.argmin`` does), d <=
    max_dist, and d * ratio_den < second_best * ratio_num."""
    d = hamming_matrix(desc_a, valid_a, desc_b, valid_b)
    best_b = torch.argmin(d, dim=-1)  # (..., Ka)
    best_ab = d.gather(-1, best_b[..., None])[..., 0]
    second = d.scatter(-1, best_b[..., None], BITS + 1).min(dim=-1).values

    best_a = torch.argmin(d, dim=-2)  # (..., Kb)
    ka = d.shape[-2]
    mutual = best_a.gather(-1, best_b) == torch.arange(ka, device=d.device)
    ok = (mutual & (best_ab <= max_dist)
          & (best_ab * ratio_den < second * ratio_num) & valid_a)
    return Matches(torch.where(ok, best_b, -1).to(torch.int32),
                   torch.where(ok, best_ab, BITS + 1).to(torch.int32))


def match_points(kps_a_xy: torch.Tensor, kps_b_xy: torch.Tensor,
                 matches: Matches) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matched coordinate pairs: (pts_a (..., K, 2), pts_b (..., K, 2),
    valid (..., K)) with unmatched slots zeroed."""
    ok = matches.idx_b >= 0
    sel = torch.where(ok, matches.idx_b, 0).long()
    pts_b = kps_b_xy.gather(-2, sel[..., None].expand(*sel.shape, 2))
    return (torch.where(ok[..., None], kps_a_xy, 0), torch.where(ok[..., None], pts_b, 0), ok)

