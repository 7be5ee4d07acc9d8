"""The detection cells' frames: a pool of distinct 1080p frames made from the
seed, and batches that are seeded permutations of it.

The pool's frames are seeded rolls (wrapping) and flips of the natural
1920 x 1080 grey frame ``golden_1080p.npz`` (a copy of the repository's
``media/golden_1080p.png``), so every frame keeps natural corner statistics
and every seed gives the same amount of work within a few corners.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_1080p.npz")


def golden() -> np.ndarray:
    """The (1080, 1920) u8 frame."""
    with np.load(GOLDEN) as z:
        return z["frame"]


def pool(seed: int, n: int, height: int, width: int) -> np.ndarray:
    """(n, height, width) u8: frame i is the golden frame rolled by a seeded
    (dy, dx) and flipped by seeded bits, cut to height x width."""
    base = golden()
    if base.shape[0] < height or base.shape[1] < width:
        raise ValueError(f"the golden frame {base.shape} is smaller than {height}x{width}")
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    out = np.empty((n, height, width), np.uint8)
    for i in range(n):
        dy, dx = (int(v) for v in rng.integers(0, base.shape, size=2))
        f = np.roll(base, (dy, dx), axis=(0, 1))
        if rng.integers(2):
            f = f[::-1]
        if rng.integers(2):
            f = f[:, ::-1]
        out[i] = f[:height, :width]
    return out


def permutations(seed: int, n: int, pool_size: int, batch: int) -> List[np.ndarray]:
    """``n`` seeded index arrays of ``batch`` distinct pool frames each."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    return [rng.permutation(pool_size)[:batch] for _ in range(n)]
