"""Host-facing detection API.

Counterpart of ``feature_detector_fast_tpu.api``, mirroring the reference's
`lib.rs` entry points: free function ``detect`` (lib.rs:62-64) and
``Config.detect`` (lib.rs:56-58), returning keypoints in row-major order
exactly like the reference's `Vec<Point>`.

The main path is: frames to the device, the FAST kernel's packed words
(ops/fast_cuda.py), then an exact row-major keypoint list decoded on the
device (ops/compact.py) and split per frame on the host.  Every entry point
takes an explicit ``device``: ``"cuda"`` (the default) runs the kernel and
raises if CUDA is absent; ``"cpu"`` runs the plain PyTorch version.

Unlike the JAX package, no entry point takes ``max_supers``: the list is
exact in one pass, so there is no compaction cap to size or grow.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .config import Config, NonmaxMode, Point
from .ops import compact, fast_cuda
from .utils import tracing

ImageLike = Union[np.ndarray, torch.Tensor]

#: Score upper bound across modes: MaxThreshold <= 255 (a u8 threshold);
#: SumAbsolute <= 16 * 255.  Strongest-K bisects over [0, _SCORE_MAX].
_SCORE_MAX = 4096


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' for the plain PyTorch path")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _as_images(image: ImageLike, expect_ndim: int, device) -> torch.Tensor:
    dev = _device(device)
    img = image if isinstance(image, torch.Tensor) else torch.as_tensor(np.asarray(image))
    if img.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 grayscale image, got dtype {img.dtype}")
    if img.dim() != expect_ndim:
        raise ValueError(
            f"expected a {expect_ndim}-D image array, got shape {tuple(img.shape)}")
    with tracing.span("detect.h2d"):
        return img.to(dev).contiguous()


def detect_batch_device(
    images: ImageLike, config: Optional[Config] = None, *, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-resident batched detection for on-device consumers: returns
    (words (B, H, ceil(W/32)) int32, n (B,) int64 keypoints per frame)
    without any host transfer or synchronisation."""
    config = config or Config()
    imgs = _as_images(images, 3, device)
    with tracing.span("detect.launch"):
        words = fast_cuda.detect_words(imgs, config.threshold, config.count, config.nonmax)
        return words, compact.count_points(words)


def detect_batch_arrays(
    images: ImageLike, config: Optional[Config] = None, *, device="cuda"
) -> List[np.ndarray]:
    """Detect over a (B, H, W) u8 batch; returns a list of per-frame (N_i, 2)
    uint32 arrays of (x, y) rows in row-major order."""
    with tracing.span("detect.batch"):
        words, _ = detect_batch_device(images, config, device=device)
        return compact.split_frames(compact.words_to_points(words), words.shape[0])


def detect_arrays(image: ImageLike, config: Optional[Config] = None, *, device="cuda") -> np.ndarray:
    """Detect keypoints; returns an (N, 2) uint32 array of (x, y) rows in
    row-major image order."""
    img = _as_images(image, 2, device)
    return detect_batch_arrays(img[None], config, device=device)[0]


def detect(image: ImageLike, config: Optional[Config] = None, *, device="cuda") -> List[Point]:
    """Detect keypoints as a list of :class:`Point` (reference: lib.rs:62-64)."""
    xy = detect_arrays(image, config, device=device)
    return [Point(int(x), int(y)) for x, y in xy]


def detect_strongest_arrays(
    image: ImageLike, config: Optional[Config] = None, *, k: int, device="cuda"
) -> Tuple[np.ndarray, int]:
    """Detect and keep the ~k strongest keypoints (requires a score mode).

    Returns (xy (N, 2) uint32 in row-major order, score threshold used).
    The threshold is the largest T with count(score >= T) >= min(k, total),
    found by the JAX package's 13-step bisection on the dense kernel's
    score, on the device; N exceeds k only when keypoints tie at T.  A
    frame with no keypoints gives T = 4096."""
    config = config or Config()
    if config.nonmax is NonmaxMode.OFF:
        raise ValueError("detect_strongest requires a score mode "
                         "(MAX_THRESHOLD or SUM_ABSOLUTE)")
    img = _as_images(image, 2, device)[None]
    mask, score = fast_cuda.detect_dense(img, config.threshold, config.count, config.nonmax)
    mask = mask.to(torch.bool)
    s = torch.where(mask, score.to(torch.int32), -1)
    want = torch.clamp(mask.sum(), max=int(k))

    # Invariant: count(s >= lo) >= want, count(s >= hi) < want.
    lo = torch.zeros((), dtype=torch.int64, device=img.device)
    hi = torch.full((), _SCORE_MAX + 1, dtype=torch.int64, device=img.device)
    for _ in range(13):  # 2**13 > _SCORE_MAX + 1
        mid = (lo + hi) // 2
        ok = (s >= mid).sum() >= want
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    keep = mask & (s >= lo)
    xy = compact.split_frames(torch.nonzero(keep), 1)[0]
    return xy, int(lo)
