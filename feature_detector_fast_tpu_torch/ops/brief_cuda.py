"""Dense BRIEF-256 words for every pixel: the hand-written kernel
``csrc/brief.cu`` (entry ``fdf_brief_words``) and its plain PyTorch version.

Replaces the TPU kernel ``feature_detector_fast_tpu/ops/brief_pallas.py``
``_kernel`` (:47, entry ``describe_words_padded`` :88).  Layout: (B, WORDS,
H, W) int32, plane j holding the JAX package's tuple element j without its
tile padding.  Bit b of plane j at pixel p is ``blur(p + o1) < blur(p + o2)``
for ``PATTERN[32j + b] = (o1, o2)``, where ``blur`` is ``models.brief``'s
clamped 5x5 box sum, ``blur(y, x) = S5x5(clamp(y, 2, H-3), clamp(x, 2,
W-3))``, extended past the frame by the same clamp.  That defines the planes
on every pixel, so kernel and plain version agree everywhere; the JAX
package's planes agree with them where it defines its own, at least BORDER
from every edge.

:func:`describe_words` takes a (B, H, W) u8 tensor.  On a CUDA tensor it
checks it (device, dtype, rank, contiguity), allocates the planes with
``torch.empty``, launches on the current stream and raises if the launch
reports an error; on a CPU tensor, and only there, it runs
:func:`describe_words_plain`.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..models.brief import PATCH_R, PATTERN, WORDS, box_blur5

#: Kernel launches; incremented only where the kernel launches.
LAUNCHES = {"brief_words": 0}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (on first use) and bind ``csrc/brief.cu``."""
    from ..utils import cuda_build

    lib = cuda_build.load("brief.cu")
    lib.fdf_brief_set_pattern.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fdf_brief_set_pattern.restype = ctypes.c_int
    lib.fdf_brief_words.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                    + [ctypes.c_void_p])  # B, H, W, device, stream
    lib.fdf_brief_words.restype = ctypes.c_int
    lib.fdf_error_string.argtypes = [ctypes.c_int]
    lib.fdf_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = load_library().fdf_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} (cudaError {err})")


@functools.lru_cache(maxsize=None)
def _upload_pattern(device_index: int) -> None:
    """Copy PATTERN into the kernel's constant memory on one device, once."""
    pattern = np.ascontiguousarray(PATTERN, dtype=np.int32)
    _raise_on(load_library().fdf_brief_set_pattern(pattern.ctypes.data, device_index),
              "copying the BRIEF pattern to the device")


def _check(images: torch.Tensor) -> None:
    if not isinstance(images, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(images).__name__}")
    if images.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 batch, got dtype {images.dtype}")
    if images.dim() != 3:
        raise ValueError(f"expected a (B, H, W) batch, got shape {tuple(images.shape)}")
    if images.shape[1] < 5 or images.shape[2] < 5:
        raise ValueError(f"frames too small for the 5x5 blur: {tuple(images.shape)}")
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {images.device}")
    if images.device.type == "cuda" and not images.is_contiguous():
        raise ValueError("the kernel takes a contiguous batch")


def describe_words_plain(images: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: (B, H, W) u8 -> (B, WORDS,
    H, W) int32, one pair of shifted views of the extended blur per bit."""
    b, h, w = images.shape
    blur = box_blur5(images)
    r = PATCH_R
    rows = (torch.arange(-r, h + r, device=images.device)).clamp(0, h - 1)
    cols = (torch.arange(-r, w + r, device=images.device)).clamp(0, w - 1)
    ext = blur.index_select(1, rows).index_select(2, cols)  # (B, H+2r, W+2r)

    def tap(dx: int, dy: int) -> torch.Tensor:
        return ext[:, r + dy: r + dy + h, r + dx: r + dx + w]

    planes = torch.zeros((b, WORDS, h, w), dtype=torch.int32, device=images.device)
    for j in range(WORDS):
        for bit in range(32):
            (x1, y1), (x2, y2) = PATTERN[32 * j + bit].tolist()
            # int32 shift: bit 31 lands on the sign bit.
            planes[:, j] |= (tap(x1, y1) < tap(x2, y2)).to(torch.int32) << bit
    return planes


def describe_words(images: torch.Tensor) -> torch.Tensor:
    """Every pixel's BRIEF-256 words, (B, WORDS, H, W) int32."""
    _check(images)
    if images.device.type == "cpu":
        return describe_words_plain(images)
    b, h, w = images.shape
    planes = torch.empty((b, WORDS, h, w), dtype=torch.int32, device=images.device)
    if images.numel():
        lib = load_library()
        _upload_pattern(images.device.index)
        _raise_on(lib.fdf_brief_words(
            images.data_ptr(), planes.data_ptr(), b, h, w, images.device.index,
            torch.cuda.current_stream(images.device).cuda_stream), "BRIEF kernel launch")
        LAUNCHES["brief_words"] += 1
    return planes


def gather_descriptors(planes: torch.Tensor, xy: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """(B, K, WORDS) int32 descriptors at (B, K, 2) positions of (B, WORDS,
    H, W) planes; invalid slots read pixel (0, 0) and coordinates are
    clamped into the frame, as the JAX package's gather does."""
    b, _, h, w = planes.shape
    x = torch.where(valid, xy[..., 0], 0).clamp(0, w - 1)
    y = torch.where(valid, xy[..., 1], 0).clamp(0, h - 1)
    at = (y * w + x).long()  # (B, K)
    flat = planes.reshape(b, WORDS, h * w)
    idx = at[:, None, :].expand(b, WORDS, at.shape[1])
    return flat.gather(2, idx).transpose(1, 2).contiguous()
