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

The kernel reads the pattern as a pair table built here
(:func:`pair_table`): each endpoint's word offset in the block's blurred
region, held as u16 cells paired two to a word in two copies (the second
shifted one column), for the kernel's tiling (``TILE_W`` ... below, which
``tests/test_torch_brief.py`` holds equal to ``brief.cu``'s).  The table is
compiled into ``csrc/brief.cu`` (:func:`pair_macros` writes its ``BEGIN
PAIRS`` block), so every offset is an immediate and the compiler loads a
cell that several pairs read once.

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


#: The kernel's tiling (``csrc/brief.cu``), which the pair table is built
#: for: a block covers TILE_W x TILE_H pixels, a lane two adjacent columns
#: of ROWS rows, and each row of the blurred region (TILE_W + 2 * PATCH_R
#: u16 cells) is held twice in ROW_WORDS 32-bit words (odd: no bank conflict
#: down a column): copy 0 pairs cells (2k, 2k+1) from word 0, copy 1 pairs
#: (2k+1, 2k+2) from word COPY_WORDS.
TILE_W, TILE_H, ROWS = 64, 32, 4
COPY_WORDS = 48
ROW_WORDS = 2 * COPY_WORDS + 1


def pair_table() -> np.ndarray:
    """(BITS, 2) int32: the word offsets of both endpoints of each PATTERN
    pair in the blurred region, relative to the word a lane reads for its
    own pixel pair (x, x+1), x even: the cells (x + dx, x + 1 + dx) of row
    y + dy sit in copy 0 where dx + PATCH_R is even, else in copy 1."""
    c = PATTERN[..., 0] + PATCH_R
    off = (PATTERN[..., 1] + PATCH_R) * ROW_WORDS + (c & 1) * COPY_WORDS + (c >> 1)
    return np.ascontiguousarray(off, dtype=np.int32)


def pair_order(j: int) -> list:
    """The order in which ``brief.cu`` takes plane j's 32 pairs: by the
    column of the leftmost endpoint, then the first endpoint's row, so that
    pairs which read the same cells run close together."""
    pats = PATTERN[32 * j: 32 * j + 32]
    return sorted(range(32), key=lambda b: (int(min(pats[b, 0, 0], pats[b, 1, 0])),
                                            int(pats[b, 0, 1]), b))


def pair_macros() -> str:
    """The block between ``// BEGIN PAIRS`` and ``// END PAIRS`` of
    ``csrc/brief.cu``: one ``FDF_PAIRS_<j>(X)`` macro a plane, listing
    ``X(bit, offset 1, offset 2)`` of :func:`pair_table` in
    :func:`pair_order`."""
    table = pair_table()
    lines = []
    for j in range(WORDS):
        items = [f"X({b}, {table[32 * j + b, 0]}, {table[32 * j + b, 1]})" for b in pair_order(j)]
        lines.append(f"#define FDF_PAIRS_{j}(X) \\\n  " + " \\\n  ".join(
            " ".join(items[i:i + 4]) for i in range(0, 32, 4)))
    return "\n".join(lines) + "\n"


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built ``brief.cu``'s entry points."""
    lib.fdf_brief_words.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                    + [ctypes.c_void_p])  # B, H, W, device, stream
    lib.fdf_brief_words.restype = ctypes.c_int
    lib.fdf_error_string.argtypes = [ctypes.c_int]
    lib.fdf_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (on first use) and bind ``csrc/brief.cu``."""
    from ..utils import cuda_build

    return bind(cuda_build.load("brief.cu"))


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fdf_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} (cudaError {err})")


def run(lib: ctypes.CDLL, images: torch.Tensor, planes: torch.Tensor) -> None:
    """Launch ``lib``'s ``fdf_brief_words`` on checked tensors (the one
    place that knows its C argument order); raises on a launch error."""
    b, h, w = images.shape
    _raise_on(lib, lib.fdf_brief_words(
        images.data_ptr(), planes.data_ptr(), b, h, w, images.device.index,
        torch.cuda.current_stream(images.device).cuda_stream), "BRIEF kernel launch")


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
        run(load_library(), images, planes)
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
