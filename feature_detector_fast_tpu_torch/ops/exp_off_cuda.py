"""Entry points of the OFF-floor experiment kernels (``csrc/exp_off.cu``).

Replace the Pallas kernels of the JAX package's TPU experiment tools:
``tools/exp_off_floor.py`` ``pallas-1in`` (:87), ``pallas-3in`` (:105) and
``pallas-win`` (:128) become :func:`floor_load`, :func:`floor_triple` and
:func:`floor_prefilter`; ``tools/exp_off_prepack.py`` (:126) becomes
:func:`words_prepacked`; ``tools/exp_off_byteswar.py`` (:107, bodies ``k16``
and ``k8``) becomes :func:`swar_pred16` and :func:`swar_pred8`.  They are
micro-benchmarks of the OFF words kernel, run by the port's tools
(``tools/exp_off_*.py``).

On a CUDA tensor each entry point checks its arguments (device, dtype,
rank, shape, contiguity), allocates the output with ``torch.empty``,
launches on the current stream without synchronising, and raises if the
launch reports an error.  On a CPU tensor, and only there, it runs the
plain version in ``ops/exp_off.py``.  ``LAUNCHES`` counts kernel launches
per entry point (the floor per stage).  :func:`bind` declares the C
interface on another build with the same interface, which the tools'
``--baseline`` launches through ``_run_floor`` and ``_run_prepacked``
(uncounted: those are not this source's kernels).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import Config, NonmaxMode
from . import compact, exp_off
from .exp_off import LOAD, PREFILTER, TRIPLE

#: Kernel launches per entry point; incremented only where a kernel launches.
LAUNCHES = {"floor_load": 0, "floor_triple": 0, "floor_prefilter": 0,
            "words_prepacked": 0, "pred16": 0, "pred8": 0}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (on first use) and bind ``csrc/exp_off.cu``."""
    from ..utils import cuda_build

    return bind(cuda_build.load("exp_off.cu"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``exp_off.cu``'s entry points on ``lib`` (a
    build of this source or of another revision with the same interface)."""
    # img, words; B, H, W, then the stage's own arguments (none; span;
    # threshold, need), device; stream
    for fn, n_args in ((lib.fdf_off_floor_load, 0), (lib.fdf_off_floor_triple, 1),
                       (lib.fdf_off_floor_prefilter, 2)):
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * (4 + n_args)
                       + [ctypes.c_void_p])
    # plane, words; B, n_rows, pitch, H, W, threshold, count, device; stream
    lib.fdf_fast_words_prepacked.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                                             + [ctypes.c_void_p])
    for fn in (lib.fdf_swar_pred16, lib.fdf_swar_pred8):
        # three planes in, one out; n; device; stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.fdf_off_floor_load, lib.fdf_off_floor_triple, lib.fdf_off_floor_prefilter,
               lib.fdf_fast_words_prepacked, lib.fdf_swar_pred16, lib.fdf_swar_pred8):
        fn.restype = ctypes.c_int
    lib.fdf_error_string.argtypes = [ctypes.c_int]
    lib.fdf_error_string.restype = ctypes.c_char_p
    return lib


def _launch(lib: ctypes.CDLL, name: str, device: torch.device, *args) -> None:
    """``lib.<name>(*args, device, stream)`` on the device's current stream;
    raise if the launch reports an error."""
    err = getattr(lib, name)(*args, device.index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.fdf_error_string(err).decode()
        raise RuntimeError(f"exp_off kernel launch failed: {msg} (cudaError {err})")


def _check_tensor(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor for {what}, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"expected {dtype} {what}, got dtype {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"the kernel takes a contiguous {what}")


def _words_out(b: int, h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.empty((b, h, -(-w // compact.WORD_BITS)), dtype=torch.int32, device=device)


def _run_floor(lib: ctypes.CDLL, stage: str, images: torch.Tensor, *args) -> torch.Tensor:
    """Launch ``lib``'s ``stage`` floor on a checked (B, H, W) u8 CUDA batch,
    given the stage's own C arguments: (B, H, ceil(W/32)) int32 words.
    Counts nothing (the entry points below count their own launches)."""
    b, h, w = images.shape
    words = _words_out(b, h, w, images.device)
    if words.numel():
        _launch(lib, f"fdf_off_floor_{stage}", images.device, images.data_ptr(),
                words.data_ptr(), b, h, w, *args)
    return words


def _floor(stage: str, images: torch.Tensor, *args) -> torch.Tensor:
    words = _run_floor(load_library(), stage, images, *args)
    if words.numel():
        LAUNCHES[f"floor_{stage}"] += 1
    return words


def _check_batch(images: torch.Tensor) -> None:
    _check_tensor(images, torch.uint8, "(B, H, W) u8 batch")
    if images.dim() != 3:
        raise ValueError(f"expected a (B, H, W) batch, got shape {tuple(images.shape)}")


def floor_load(images: torch.Tensor) -> torch.Tensor:
    """The ``LOAD`` floor (:func:`exp_off.floor_load`) of a (B, H, W) u8
    batch: (B, H, ceil(W/32)) int32 words."""
    _check_batch(images)
    if images.device.type == "cpu":
        return exp_off.floor_load(images)
    return _floor(LOAD, images)


def floor_triple(images: torch.Tensor, span: int = exp_off.TILE_H) -> torch.Tensor:
    """The ``TRIPLE`` floor (:func:`exp_off.floor_triple`) at ``span`` rows."""
    _check_batch(images)
    if int(span) < 1:
        raise ValueError(f"span must be >= 1, got {span}")
    if images.device.type == "cpu":
        return exp_off.floor_triple(images, int(span))
    return _floor(TRIPLE, images, int(span))


def floor_prefilter(images: torch.Tensor, threshold: int = 16, count: int = 9) -> torch.Tensor:
    """The ``PREFILTER`` floor (:func:`exp_off.floor_prefilter`) at
    ``threshold`` and the cardinal-tap need of ``count``."""
    _check_batch(images)
    cfg = Config(threshold, count, NonmaxMode.OFF)  # validates the threshold and count
    if images.device.type == "cpu":
        return exp_off.floor_prefilter(images, cfg.threshold, cfg.count)
    return _floor(PREFILTER, images, cfg.threshold, exp_off.need_for(cfg.count))


#: The floor entry points by stage name, as :data:`exp_off.FLOORS`.
FLOORS = {LOAD: floor_load, TRIPLE: floor_triple, PREFILTER: floor_prefilter}


def words_prepacked(plane: torch.Tensor, threshold: int, count: int, *, height: int,
                    width: int) -> torch.Tensor:
    """OFF keypoint words, (B, height, ceil(width/32)) int32, of the frames
    held by a (B, n_tiles * 72, wp) int32 plane from :func:`exp_off.prepack`:
    equal to ``fast_cuda.detect_words(frames, threshold, count, OFF)``."""
    _check_tensor(plane, torch.int32, "prepacked plane")
    cfg = Config(threshold, count, NonmaxMode.OFF)
    if plane.dim() != 3 or plane.shape[1] % exp_off.PACKED_ROWS or not plane.shape[1]:
        raise ValueError(f"expected a (B, n_tiles * {exp_off.PACKED_ROWS}, wp) plane, got "
                         f"shape {tuple(plane.shape)}")
    rows, pitch = plane.shape[1:]
    h, w = int(height), int(width)
    if not 1 <= h <= rows // exp_off.PACKED_ROWS * exp_off.TILE_H or not 1 <= w <= pitch:
        raise ValueError(f"frame {height} x {width} does not fit plane {tuple(plane.shape)}")
    if plane.device.type == "cpu":
        return exp_off.words_prepacked(plane, cfg.threshold, cfg.count, height=h, width=w)
    words = _run_prepacked(load_library(), plane, h, w, cfg.threshold, cfg.count)
    if words.numel():
        LAUNCHES["words_prepacked"] += 1
    return words


def _run_prepacked(lib: ctypes.CDLL, plane: torch.Tensor, height: int, width: int,
                   threshold: int, count: int) -> torch.Tensor:
    """Launch ``lib``'s prepacked words kernel on a checked CUDA plane:
    (B, height, ceil(width/32)) int32 words.  Counts nothing."""
    b, rows, pitch = plane.shape
    words = _words_out(b, height, width, plane.device)
    if words.numel():
        _launch(lib, "fdf_fast_words_prepacked", plane.device, plane.data_ptr(),
                words.data_ptr(), b, rows, pitch, height, width, threshold, count)
    return words


def _pred(name: str, plain, x: torch.Tensor, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    for t, what in ((x, "x plane"), (a, "second plane"), (c, "third plane")):
        _check_tensor(t, torch.int32, what)
    if not (x.shape == a.shape == c.shape) or not (x.device == a.device == c.device):
        raise ValueError(f"the three planes must share shape and device, got "
                         f"{[tuple(t.shape) for t in (x, a, c)]} on "
                         f"{[str(t.device) for t in (x, a, c)]}")
    if x.device.type == "cpu":
        return plain(x, a, c)
    out = torch.empty_like(x)
    if out.numel():
        _launch(load_library(), f"fdf_swar_{name}", x.device, x.data_ptr(), a.data_ptr(),
                c.data_ptr(), out.data_ptr(), out.numel())
        LAUNCHES[name] += 1
    return out


def swar_pred16(x: torch.Tensor, hb: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """The 16-bit-field predicate sequence (:func:`exp_off.swar_pred16`)
    elementwise over three int32 planes of one shape."""
    return _pred("pred16", exp_off.swar_pred16, x, hb, cw)


def swar_pred8(x: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The 8-bit-field predicate sequence (:func:`exp_off.swar_pred8`)
    elementwise over three int32 planes of one shape."""
    return _pred("pred8", exp_off.swar_pred8, x, hi, lo)
