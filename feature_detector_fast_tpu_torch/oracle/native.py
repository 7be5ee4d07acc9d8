"""ctypes wrapper around the native C++ scalar oracle (a copy of
``feature_detector_fast_tpu.oracle.native``).

Builds `native_src/fast_oracle.cpp` with g++ on first use (cached in a
build directory keyed by source hash) and exposes the same oracle API as
`oracle.naive`, but fast enough for full-frame differential tests.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

from ..config import Config, NonmaxMode, Point
from ..utils.native_build import build_shared_lib

_SRC = os.path.join(os.path.dirname(__file__), "native_src", "fast_oracle.cpp")

_MODE_CODE = {
    NonmaxMode.OFF: 0,
    NonmaxMode.MAX_THRESHOLD: 1,
    NonmaxMode.SUM_ABSOLUTE: 2,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_shared_lib(_SRC))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
            i32 = ctypes.c_int32
            lib.fast_oracle_detect.argtypes = [u8p, i32, i32, i32, i32, i32, u32p, i32]
            lib.fast_oracle_detect.restype = i32
            lib.fast_oracle_is_keypoint.argtypes = [u8p, i32, i32, i32, i32, i32, i32]
            lib.fast_oracle_is_keypoint.restype = i32
            lib.fast_oracle_score_max_threshold.argtypes = [u8p, i32, i32, i32, i32, i32]
            lib.fast_oracle_score_max_threshold.restype = ctypes.c_uint16
            lib.fast_oracle_score_sum_abs.argtypes = [u8p, i32, i32, i32, i32, i32]
            lib.fast_oracle_score_sum_abs.restype = ctypes.c_uint16
            _lib = lib
    return _lib


def detect_arrays(image: np.ndarray, config: Optional[Config] = None) -> np.ndarray:
    """Full oracle detector -> (N, 2) uint32 (x, y), row-major order."""
    config = config or Config()
    img = np.ascontiguousarray(image, np.uint8)
    h, w = img.shape
    lib = _load()
    cap = 1 << 16
    while True:
        out = np.empty((cap, 2), np.uint32)
        n = lib.fast_oracle_detect(
            img, h, w, int(config.threshold), int(config.count),
            _MODE_CODE[config.nonmax], out.reshape(-1), cap,
        )
        if n < 0:
            raise ValueError("invalid oracle arguments")
        if n <= cap:
            return out[:n].copy()
        cap = n


def detector(image: np.ndarray, config: Optional[Config] = None) -> List[Point]:
    return [Point(int(x), int(y)) for x, y in detect_arrays(image, config)]


def score_max_threshold(image: np.ndarray, xy, count: int) -> int:
    img = np.ascontiguousarray(image, np.uint8)
    h, w = img.shape
    return int(_load().fast_oracle_score_max_threshold(
        img, h, w, int(xy[0]), int(xy[1]), int(count)))


def score_sum_abs(image: np.ndarray, xy, threshold: int) -> int:
    img = np.ascontiguousarray(image, np.uint8)
    h, w = img.shape
    return int(_load().fast_oracle_score_sum_abs(
        img, h, w, int(xy[0]), int(xy[1]), int(threshold)))


def is_keypoint(image: np.ndarray, xy, threshold: int, count: int) -> bool:
    img = np.ascontiguousarray(image, np.uint8)
    h, w = img.shape
    return bool(_load().fast_oracle_is_keypoint(
        img, h, w, int(xy[0]), int(xy[1]), int(threshold), int(count)))
