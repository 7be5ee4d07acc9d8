"""Per-keypoint patch extraction: the hand-written kernels ``csrc/patch.cu``
(entries ``fdf_extract_windows`` and ``fdf_extract_patches``) and their
plain PyTorch versions.

Replaces the TPU kernels of ``feature_detector_fast_tpu/ops/patch_pallas.py``:
``_fused_kernel_resident`` (:147) and its strip-DMA twin ``_fused_kernel``
(:123), entry ``extract_windows_fused`` (:187), become
:func:`extract_windows_fused`; ``_kernel`` (:69), entry ``extract_patches``
(:313), becomes :func:`extract_patches`.  One CUDA kernel serves both fused
TPU forms: the TPU chose between them by whether the frame fit VMEM, and
Hopper reads every window through L2 whatever the frame's size.

Both entry points take a (B, H, W) batch and (B, K, 2) int coordinates
(x, y).  On a CUDA tensor they check it (device, dtype, rank, contiguity),
allocate the output with ``torch.empty``, launch on the current stream and
raise if the launch reports an error; on a CPU tensor, and only there, they
run the plain version beside them.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.brief import PATCH_R, box_blur5

#: Patch rows/cols consumed downstream (2 * PATCH_R + 1).
PATCH = 2 * PATCH_R + 1
#: Rows and columns of an :func:`extract_patches` window (the JAX package's
#: (32, 128) TPU tile); the 31 x 31 patch sits in its top-left corner.
WIN_H = 32
LANES = 128
#: Raw pixels ride bits [RAW_SHIFT, RAW_SHIFT + 8) of a fused window (blur5
#: sums are <= 25 * 255 = 6375 < 2**RAW_SHIFT).
RAW_SHIFT = 13
#: Fused-window coordinate margin: patch half-size + blur radius.
_MARGIN = PATCH_R + 2

#: Kernel launches per entry point; incremented only where a kernel launches.
LAUNCHES = {"extract_windows": 0, "extract_patches": 0}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built ``patch.cu``'s entry points."""
    args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]  # B, H, W, K, device
    for fn in (lib.fdf_extract_windows, lib.fdf_extract_patches):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.fdf_error_string.argtypes = [ctypes.c_int]
    lib.fdf_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (on first use) and bind ``csrc/patch.cu``."""
    from ..utils import cuda_build

    return bind(cuda_build.load("patch.cu"))


def _check(frames: torch.Tensor, xy: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Validate the arguments; returns xy as int32 on the frames' device."""
    for name, t in (("frames", frames), ("xy", xy)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected {name} as a torch.Tensor, got {type(t).__name__}")
    if frames.dtype != dtype:
        raise TypeError(f"expected {dtype} frames, got dtype {frames.dtype}")
    if frames.dim() != 3:
        raise ValueError(f"expected a (B, H, W) batch, got shape {tuple(frames.shape)}")
    if xy.dim() != 3 or xy.shape[0] != frames.shape[0] or xy.shape[2] != 2:
        raise ValueError(f"expected (B, K, 2) coordinates for {frames.shape[0]} frames, "
                         f"got shape {tuple(xy.shape)}")
    if xy.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"expected integer coordinates, got dtype {xy.dtype}")
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {frames.device}")
    if xy.device != frames.device:
        raise ValueError(f"coordinates on {xy.device}, frames on {frames.device}")
    if frames.device.type == "cuda" and not frames.is_contiguous():
        raise ValueError("the kernel takes a contiguous batch")
    return xy.to(torch.int32)


def _launch(fn, frames: torch.Tensor, xy: torch.Tensor, out: torch.Tensor) -> None:
    b, h, w = frames.shape
    xy = xy.contiguous()
    err = fn(frames.data_ptr(), xy.data_ptr(), out.data_ptr(), b, h, w, xy.shape[1],
             frames.device.index, torch.cuda.current_stream(frames.device).cuda_stream)
    if err != 0:
        msg = load_library().fdf_error_string(err).decode()
        raise RuntimeError(f"patch kernel launch failed: {msg} (cudaError {err})")


def _gather(flat: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, w: int) -> torch.Tensor:
    """flat (B, H*W) at rows (B, K, R) x cols (B, K, C) -> (B, K, R, C)."""
    at = rows[..., :, None] * w + cols[..., None, :]
    b, k, r, c = at.shape
    return flat.gather(1, at.reshape(b, -1).long()).reshape(b, k, r, c)


def extract_windows_plain(images: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """The plain version of ``fdf_extract_windows``: box_blur5 | raw << 13
    of the whole frames, gathered at each keypoint's clamped 31 x 31 cells."""
    b, h, w = images.shape
    x = xy[..., 0].clamp(_MARGIN, w - _MARGIN - 1)
    y = xy[..., 1].clamp(_MARGIN, h - _MARGIN - 1)
    packed = box_blur5(images) | (images.to(torch.int32) << RAW_SHIFT)
    d = torch.arange(-PATCH_R, PATCH_R + 1, dtype=torch.int32, device=images.device)
    return _gather(packed.reshape(b, h * w), y[..., None] + d, x[..., None] + d, w)


def extract_windows_fused(images: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(B, K, PATCH, PATCH) int32 windows of (B, H, W) u8 frames:
    ``out[b, k, r, c] = blur5(y-15+r, x-15+c) | raw(y-15+r, x-15+c) << 13``
    with blur5 the 25-pixel box sum of ``models.brief.box_blur5``.  The
    coordinates are clamped to [17, W-18] x [17, H-18], so every cell's blur
    halo lies in the frame; frames must be at least 35 x 35."""
    xy = _check(images, xy, torch.uint8)
    _, h, w = images.shape
    if h < 2 * _MARGIN + 1 or w < 2 * _MARGIN + 1:
        raise ValueError(f"image too small for fused extraction: {h}x{w}")
    if images.device.type == "cpu":
        return extract_windows_plain(images, xy)
    out = torch.empty((*xy.shape[:2], PATCH, PATCH), dtype=torch.int32, device=images.device)
    if out.numel():
        _launch(load_library().fdf_extract_windows, images, xy, out)
        LAUNCHES["extract_windows"] += 1
    return out


def extract_patches_plain(planes: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """The plain version of ``fdf_extract_patches``."""
    b, h, w = planes.shape
    x = xy[..., 0].clamp(PATCH_R, w - PATCH_R - 1)
    y = xy[..., 1].clamp(PATCH_R, h - PATCH_R - 1)
    rows = y[..., None] - PATCH_R + torch.arange(WIN_H, dtype=torch.int32, device=planes.device)
    cols = x[..., None] - PATCH_R + torch.arange(LANES, dtype=torch.int32, device=planes.device)
    inside = (((rows >= 0) & (rows < h))[..., :, None]
              & ((cols >= 0) & (cols < w))[..., None, :])
    vals = _gather(planes.reshape(b, h * w), rows.clamp(0, h - 1), cols.clamp(0, w - 1), w)
    return torch.where(inside, vals, 0)


def extract_patches(planes: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(B, K, WIN_H, LANES) int32 windows of (B, H, W) int32 planes:
    ``out[b, k, r, c] = plane[y-15+r, x-15+c]``, the coordinates clamped to
    [15, W-16] x [15, H-16], and 0 for cells outside the frame."""
    xy = _check(planes, xy, torch.int32)
    if planes.device.type == "cpu":
        return extract_patches_plain(planes, xy)
    out = torch.empty((*xy.shape[:2], WIN_H, LANES), dtype=torch.int32, device=planes.device)
    if out.numel():
        _launch(load_library().fdf_extract_patches, planes, xy, out)
        LAUNCHES["extract_patches"] += 1
    return out
