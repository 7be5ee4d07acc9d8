"""Entry points of the hand-written FAST kernel (``csrc/fast.cu``).

Replaces the TPU kernels of ``feature_detector_fast_tpu/ops/fast_pallas.py``:
``_kernel_words`` (:949, entry ``detect_words_padded``) becomes
:func:`detect_words`, and ``_kernel`` (:621, entry ``detect_dense_padded``)
becomes :func:`detect_dense`, and their row-shard forms ``_kernel_words_tiles``
(:1029, entry ``detect_words_tiles``) and ``_kernel_tiles`` (:647, entry
``detect_dense_tiles``) become :func:`detect_words_tiles` and
:func:`detect_dense_tiles`.  A block walks a 128-column strip, one column
per lane; a warp's ballot over 32 aligned columns is the packed word, so
the words path never writes a dense mask.  The words kernel's bound is its
integer operations (the cardinal prefilter at every pixel, the arc test
where it passes, nonmax and score at corners), the dense kernel's its
4 bytes written a pixel; see the note at the top of the source and
``tools/_common.fast_bound``.

The whole-frame entry points take a (B, H, W) u8 tensor, the tiles entry
points an (S, rows + 2*halo, W) u8 stack of row-shard slabs and an (S,)
int32 tensor of each shard's global first row.  On a CUDA tensor they check
it (device, dtype, rank, contiguity), allocate the outputs with
``torch.empty``, launch on the current stream without synchronising, and
raise if the launch reports an error.  On a CPU tensor, and only there,
they run the plain version in ``ops/fast.py``.  ``LAUNCHES`` counts kernel
launches per entry point, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..config import Config, NonmaxMode
from . import compact, fast

#: Kernel launches per entry point; incremented only where a kernel launches.
LAUNCHES = {"words": 0, "dense": 0, "words_tiles": 0, "dense_tiles": 0}

_MODE_CODE = {NonmaxMode.OFF: 0, NonmaxMode.MAX_THRESHOLD: 1, NonmaxMode.SUM_ABSOLUTE: 2}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (on first use) and bind ``csrc/fast.cu``."""
    from ..utils import cuda_build

    return bind(cuda_build.load("fast.cu"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``fast.cu``'s entry points on ``lib`` (a
    build of this source or of another revision with the same interface)."""
    ints = [ctypes.c_int] * 9  # B, H, W, row_offset, height, t, count, mode, device
    lib.fdf_fast_words.argtypes = [ctypes.c_void_p] * 2 + ints + [ctypes.c_void_p]
    lib.fdf_fast_words.restype = ctypes.c_int
    lib.fdf_fast_dense.argtypes = [ctypes.c_void_p] * 3 + ints + [ctypes.c_void_p]
    lib.fdf_fast_dense.restype = ctypes.c_int
    # S, rows, halo, W, pitch, height, t, count, mode, device
    tiles = [ctypes.c_int] * 10
    lib.fdf_fast_words_tiles.argtypes = [ctypes.c_void_p] * 3 + tiles + [ctypes.c_void_p]
    lib.fdf_fast_words_tiles.restype = ctypes.c_int
    lib.fdf_fast_dense_tiles.argtypes = [ctypes.c_void_p] * 4 + tiles + [ctypes.c_void_p]
    lib.fdf_fast_dense_tiles.restype = ctypes.c_int
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


def _run(lib: ctypes.CDLL, images: torch.Tensor, outs: Tuple[torch.Tensor, ...], cfg: Config,
         tiles: Optional[Tuple[torch.Tensor, int, int, int]] = None) -> None:
    """Launch the entry point of ``lib`` that writes ``outs``, (words,) or
    (mask, score), on the current stream of ``images``' device; raise if
    the launch reports an error.  ``images`` is a (B, H, W) batch, or with
    ``tiles`` = (row0, halo, height, width) an (S, rows + 2*halo, pitch)
    stack of row-shard slabs."""
    dev = images.device
    ptrs = [o.data_ptr() for o in outs]
    if tiles is None:
        b, h, w = images.shape
        fn = lib.fdf_fast_words if len(outs) == 1 else lib.fdf_fast_dense
        args = (images.data_ptr(), *ptrs, b, h, w, 0, h)
    else:
        row0, halo, height, width = tiles
        s, slab_h, pitch = images.shape
        fn = lib.fdf_fast_words_tiles if len(outs) == 1 else lib.fdf_fast_dense_tiles
        args = (images.data_ptr(), row0.data_ptr(), *ptrs, s, slab_h - 2 * int(halo), int(halo),
                int(width), pitch, int(height))
    err = fn(*args, cfg.threshold, cfg.count, _MODE_CODE[cfg.nonmax], dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.fdf_error_string(err).decode()
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
        _run(load_library(), images, (words,), cfg)
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
        _run(load_library(), images, (mask, score), cfg)
        LAUNCHES["dense"] += 1
    return mask, score


#: Fewest halo rows a shard slab may carry: the circle radius (3) plus the
#: nonmax ring (1).
MIN_HALO = 4


def _check_tiles(ext: torch.Tensor, row0: torch.Tensor, threshold: int, count: int,
                 nonmax, height: int, width: int, halo: int) -> Tuple[Config, int]:
    """Check a tiles call; returns its Config and the shards' own rows."""
    cfg = _check(ext, threshold, count, nonmax)
    if not isinstance(row0, torch.Tensor) or row0.dtype != torch.int32:
        raise TypeError("row0 must be an int32 tensor of each shard's global first row")
    if tuple(row0.shape) != (ext.shape[0],) or row0.device != ext.device:
        raise ValueError(f"row0 must have shape ({ext.shape[0]},) on {ext.device}, "
                         f"got {tuple(row0.shape)} on {row0.device}")
    if ext.device.type == "cuda" and not row0.is_contiguous():
        raise ValueError("the kernel takes a contiguous row0")
    if int(halo) < MIN_HALO:
        raise ValueError(f"halo must be at least {MIN_HALO} rows (circle radius + nonmax "
                         f"ring), got {halo}")
    rows = ext.shape[1] - 2 * int(halo)
    if ext.shape[0] < 1 or rows < 1:
        raise ValueError(f"expected an (S, rows + 2*{halo}, W) slab stack with S, rows >= 1, "
                         f"got shape {tuple(ext.shape)}")
    if not 1 <= int(width) <= ext.shape[2] or int(height) < 1:
        raise ValueError(f"frame {height} x {width} does not fit slabs {tuple(ext.shape)}")
    return cfg, rows


def detect_words_tiles(ext: torch.Tensor, row0: torch.Tensor, threshold: int, count: int,
                       nonmax: NonmaxMode, *, height: int, width: int,
                       halo: int) -> torch.Tensor:
    """Row-shard words: ``ext`` (S, rows + 2*halo, >= width) u8 holds each
    shard's own rows with ``halo`` rows of its neighbours above and below,
    ``row0`` (S,) int32 the global row of each shard's first own row, in a
    frame ``height`` x ``width``.  Returns (S, rows, ceil(width/32)) int32
    words of the shards' own rows, in :func:`detect_words`' layout."""
    cfg, rows = _check_tiles(ext, row0, threshold, count, nonmax, height, width, halo)
    if ext.device.type == "cpu":
        mask, _ = fast.detect_dense_tiles(ext, row0.tolist(), cfg.threshold, cfg.count,
                                          cfg.nonmax, height=height, width=width, halo=halo)
        return compact.pack_mask_words(mask)
    s = ext.shape[0]
    words = torch.empty((s, rows, -(-int(width) // compact.WORD_BITS)), dtype=torch.int32,
                        device=ext.device)
    _run(load_library(), ext, (words,), cfg, (row0, halo, height, width))
    LAUNCHES["words_tiles"] += 1
    return words


def detect_dense_tiles(ext: torch.Tensor, row0: torch.Tensor, threshold: int, count: int,
                       nonmax: NonmaxMode, *, height: int, width: int,
                       halo: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-shard dense form of :func:`detect_words_tiles`' arguments:
    (mask, score), both (S, rows, width) u16, of the shards' own rows."""
    cfg, rows = _check_tiles(ext, row0, threshold, count, nonmax, height, width, halo)
    if ext.device.type == "cpu":
        mask, score = fast.detect_dense_tiles(ext, row0.tolist(), cfg.threshold, cfg.count,
                                              cfg.nonmax, height=height, width=width, halo=halo)
        return mask.to(torch.uint16), score
    s = ext.shape[0]
    mask = torch.empty((s, rows, int(width)), dtype=torch.uint16, device=ext.device)
    score = torch.empty_like(mask)
    _run(load_library(), ext, (mask, score), cfg, (row0, halo, height, width))
    LAUNCHES["dense_tiles"] += 1
    return mask, score
