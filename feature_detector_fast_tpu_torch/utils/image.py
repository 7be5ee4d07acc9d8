"""Image I/O, luma conversion, and keypoint overlay drawing (numpy / PIL).

A copy of ``feature_detector_fast_tpu.utils.image``, which cannot be
imported without pulling in jax through its package's ``__init__``.  Parity
targets in the reference:
  * `DynamicImage::to_luma8` — the image crate's sRGB-coefficient
    luma conversion used by the CLI and tests (main.rs:58,
    tests/compare.rs:33).  For already-gray inputs (R==G==B) it is an exact
    identity, which is what the committed test image exercises.
  * `Rgb8ToLuma16View` — channel-sum luma16 and the /3 gray variant
    (util.rs:6-41); intentionally different from weighted luma, kept for
    API parity.
  * `draw_plus_sized` overlay drawing (util.rs:62-81) including its exact
    boundary behavior (skips px<=0 / py<=0 and px>=w / py>=h).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np
from PIL import Image

# Color constants (reference: util.rs:44-50).
WHITE = (255, 255, 255)
RED = (255, 0, 0)
GREEN = (0, 255, 0)
BLUE = (0, 0, 255)


def rgb_to_luma8(rgb: np.ndarray) -> np.ndarray:
    """sRGB-coefficient luma, mirroring the image crate's `to_luma8`.

    luma = (2126*R + 7152*G + 722*B) / 10000 with integer truncation
    (image-rs 0.24 `rgb_to_luma`).  Exact identity for gray inputs.
    """
    rgb = np.asarray(rgb, dtype=np.uint32)
    l = (2126 * rgb[..., 0] + 7152 * rgb[..., 1] + 722 * rgb[..., 2]) // 10000
    return l.astype(np.uint8)


def rgb_to_luma16_sum(rgb: np.ndarray) -> np.ndarray:
    """Channel-sum luma16 view (reference: util.rs:37-40)."""
    rgb = np.asarray(rgb, dtype=np.uint16)
    return rgb[..., 0] + rgb[..., 1] + rgb[..., 2]


def rgb_to_grey_third(rgb: np.ndarray) -> np.ndarray:
    """`Rgb8ToLuma16View::to_grey` (util.rs:15-25): pixel[0] of the luma16
    VIEW is the channel sum (util.rs:37-40), so gray = (R+G+B) / 3 with
    integer truncation."""
    return (rgb_to_luma16_sum(rgb) // 3).astype(np.uint8)


def load_luma8(path: str) -> np.ndarray:
    """Load an image file and convert to uint8 luma exactly like the
    reference CLI does (open -> rgb8 -> to_luma8; main.rs:53-58)."""
    rgb = np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
    return rgb_to_luma8(rgb)


def load_rgb8(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def save_image(array: np.ndarray, path: str) -> None:
    Image.fromarray(np.asarray(array)).save(path)


def draw_plus_sized(
    image: np.ndarray,
    xy: Tuple[int, int],
    color: Sequence[int],
    size: int = 3,
) -> None:
    """Draw a plus marker in-place on an (H, W, 3) uint8 image.

    Bit-faithful to util.rs:62-81: arms of length ``size`` in the four
    cardinal directions, skipping positions with px<=0, py<=0, px>=w, py>=h.
    """
    h, w = image.shape[:2]
    x, y = int(xy[0]), int(xy[1])
    for dxs, dys in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        for l in range(int(size)):
            px = x + dxs * l
            py = y + dys * l
            if px <= 0 or px >= w or py <= 0 or py >= h:
                continue
            image[py, px] = color


def make_circle_image() -> np.ndarray:
    """Debug image of the 16 circle points: 32x32 RGB with blue dots
    around center (16, 16) (reference: opencv_compat.rs:69-76)."""
    from ..geometry import CIRCLE

    img = np.zeros((32, 32, 3), np.uint8)
    for dx, dy in CIRCLE:
        img[16 + dy, 16 + dx] = BLUE
    return img


def draw_keypoints(
    luma: np.ndarray, keypoints: Iterable[Tuple[int, int]], color=RED, size: int = 1
) -> np.ndarray:
    """Gray image + keypoints -> RGB overlay (CLI behavior, main.rs:74-78)."""
    rgb = np.repeat(np.asarray(luma, np.uint8)[..., None], 3, axis=-1).copy()
    for kp in keypoints:
        draw_plus_sized(rgb, (int(kp[0]), int(kp[1])), color, size)
    return rgb
