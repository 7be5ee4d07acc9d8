"""Entry points of the hand-written FAST kernel (``csrc/fast.cu``).

Replaces the TPU kernels of ``feature_detector_fast_tpu/ops/fast_pallas.py``:
``_kernel_words`` (:949, entry ``detect_words_padded``) becomes
:func:`detect_words`, and ``_kernel`` (:621, entry ``detect_dense_padded``)
becomes :func:`detect_dense`.  One thread per pixel; a warp's ballot over 32
aligned columns is the packed word, so the words path never writes a dense
mask.  The kernel is bound by integer instruction throughput (32 compares
per pixel for the arc test, up to 480 min/max per corner for the
MaxThreshold score), not by its 1 byte read per pixel; see the note at the
top of the source.

Both entry points take a (B, H, W) u8 tensor.  On a CUDA tensor they check
it (device, dtype, rank, contiguity), allocate the outputs with
``torch.empty``, launch on the current stream without synchronising, and
raise if the launch reports an error.  On a CPU tensor, and only there,
they run the plain version in ``ops/fast.py``.  ``LAUNCHES`` counts kernel
launches per entry point, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..config import Config, NonmaxMode
from . import compact, fast

#: Kernel launches per entry point; incremented only where a kernel launches.
LAUNCHES = {"words": 0, "dense": 0}

_MODE_CODE = {NonmaxMode.OFF: 0, NonmaxMode.MAX_THRESHOLD: 1, NonmaxMode.SUM_ABSOLUTE: 2}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (on first use) and bind ``csrc/fast.cu``."""
    from ..utils import cuda_build

    lib = cuda_build.load("fast.cu")
    ints = [ctypes.c_int] * 9  # B, H, W, row_offset, height, t, count, mode, device
    lib.fdf_fast_words.argtypes = [ctypes.c_void_p] * 2 + ints + [ctypes.c_void_p]
    lib.fdf_fast_words.restype = ctypes.c_int
    lib.fdf_fast_dense.argtypes = [ctypes.c_void_p] * 3 + ints + [ctypes.c_void_p]
    lib.fdf_fast_dense.restype = ctypes.c_int
    lib.fdf_error_string.argtypes = [ctypes.c_int]
    lib.fdf_error_string.restype = ctypes.c_char_p
    return lib


def _check(images: torch.Tensor, threshold: int, count: int, nonmax) -> Config:
    if not isinstance(images, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(images).__name__}")
    if images.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 batch, got dtype {images.dtype}")
    if images.dim() != 3:
        raise ValueError(f"expected a (B, H, W) batch, got shape {tuple(images.shape)}")
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {images.device}")
    if images.device.type == "cuda" and not images.is_contiguous():
        raise ValueError("the kernel takes a contiguous batch")
    # Config validates the u8 threshold and the 9..=16 count.
    return Config(threshold, count, NonmaxMode(nonmax))


def _launch(fn, images: torch.Tensor, outs, cfg: Config) -> None:
    b, h, w = images.shape
    err = fn(
        images.data_ptr(), *(o.data_ptr() for o in outs),
        b, h, w, 0, h, cfg.threshold, cfg.count, _MODE_CODE[cfg.nonmax],
        images.device.index, torch.cuda.current_stream(images.device).cuda_stream,
    )
    if err != 0:
        msg = load_library().fdf_error_string(err).decode()
        raise RuntimeError(f"FAST kernel launch failed: {msg} (cudaError {err})")


def detect_words(images: torch.Tensor, threshold: int, count: int,
                 nonmax: NonmaxMode) -> torch.Tensor:
    """Keypoint mask packed as (B, H, ceil(W/32)) int32 words: bit b of
    word j in row y is column 32*j + b (``compact.pack_mask_words``)."""
    cfg = _check(images, threshold, count, nonmax)
    if images.device.type == "cpu":
        mask, _ = fast.detect_dense(images, cfg.threshold, cfg.count, cfg.nonmax)
        return compact.pack_mask_words(mask)
    b, h, w = images.shape
    words = torch.empty((b, h, -(-w // compact.WORD_BITS)), dtype=torch.int32,
                        device=images.device)
    if words.numel():
        _launch(load_library().fdf_fast_words, images, (words,), cfg)
        LAUNCHES["words"] += 1
    return words


def detect_dense(images: torch.Tensor, threshold: int, count: int,
                 nonmax: NonmaxMode) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask, score), both (B, H, W) u16: the final keypoint mask and the
    kp-masked score before nonmax (all zeros for OFF)."""
    cfg = _check(images, threshold, count, nonmax)
    if images.device.type == "cpu":
        mask, score = fast.detect_dense(images, cfg.threshold, cfg.count, cfg.nonmax)
        return mask.to(torch.uint16), score
    mask = torch.empty(images.shape, dtype=torch.uint16, device=images.device)
    score = torch.empty(images.shape, dtype=torch.uint16, device=images.device)
    if images.numel():
        _launch(load_library().fdf_fast_dense, images, (mask, score), cfg)
        LAUNCHES["dense"] += 1
    return mask, score
