"""Packed keypoint words to an exact, row-major keypoint list, on the device.

Counterpart of ``feature_detector_fast_tpu.ops.compact``.  The detector
kernel (ops/fast_cuda.py) emits the keypoint mask packed 32 pixels per
int32 word: bit b of word j of row y is column 32*j + b.  Turning that into
the variable-length list the reference API returns (`Vec<Point>`,
lib.rs:56-64) takes two `torch.nonzero` calls: one over the words, one over
the bits of the nonzero words.  Both emit indices in lexicographic order,
so the list comes out row-major ((b, y, x) ascending), matching the
reference's row-scan push order (fast_simd.rs:550) and the golden hashes.

The JAX package's superword `top_k` selection, its caps and the
cap-overflow retry loop answered the cost of a sort on the TPU; the list
here is exact in one pass, so none of them exist and no keypoint can be
dropped.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..utils import tracing

WORD_BITS = 32


def pack_mask_words(mask: torch.Tensor) -> torch.Tensor:
    """Pack a (..., H, W) boolean mask into (..., H, ceil(W/32)) int32 words.

    Bit b of word j in row y is ``mask[..., y, 32*j + b]`` (columns past W
    read as 0): the layout of the kernel's words entry point, and per row
    the layout of the JAX package's ``pack_mask_words`` on a 32-aligned
    width.
    """
    w = mask.shape[-1]
    pad = (-w) % WORD_BITS
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, pad))
    m = m.reshape(*mask.shape[:-1], -1, WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=mask.device)
    # Bits are distinct powers of two, so the sum is their OR; int64 -> int32
    # wraps bit 31 to the sign bit.
    return (m << shifts).sum(dim=-1).to(torch.int32)


def count_points(words: torch.Tensor) -> torch.Tensor:
    """Per-frame keypoint counts (B,) int64 of a (B, H, n_words) word batch,
    by a SWAR popcount on the device (no host synchronisation)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & 0xFFFFFFFF) >> 24
    return v.sum(dim=(1, 2))


def words_to_points(words: torch.Tensor) -> torch.Tensor:
    """Expand (B, H, n_words) int32 words to an (N, 3) int64 list of
    (b, y, x) in row-major order, on the words' device."""
    if words.dim() != 3:
        raise ValueError(f"expected (B, H, n_words) words, got shape {tuple(words.shape)}")
    with tracing.span("detect.decode"):
        nz = torch.nonzero(words)  # (M, 3): (b, y, j), lexicographic
        bits = words[nz[:, 0], nz[:, 1], nz[:, 2]]
        shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
        bitmat = (bits[:, None] >> shifts) & 1  # arithmetic shift; &1 keeps the bit
        m, bit = torch.nonzero(bitmat, as_tuple=True)  # ascending word, then bit
        row = nz[m]
        return torch.stack((row[:, 0], row[:, 1], row[:, 2] * WORD_BITS + bit), dim=1)


def split_frames(points: torch.Tensor, batch: int) -> List[np.ndarray]:
    """Split an (N, 3) row-major (b, y, x) list into ``batch`` per-frame
    (N_i, 2) uint32 arrays of (x, y) rows.  The (x, y) columns and the
    per-frame counts are formed on the points' device, so only 8 bytes per
    keypoint cross to the host."""
    with tracing.span("detect.split"):
        counts = torch.bincount(points[:, 0], minlength=batch).cpu().numpy()
        xy = points[:, [2, 1]].to(torch.int32).cpu().numpy().view(np.uint32)
        return np.split(xy, np.cumsum(counts)[:-1])
