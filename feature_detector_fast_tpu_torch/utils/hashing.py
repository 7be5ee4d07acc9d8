"""Deterministic golden hashing for regression pinning.

The reference pins a golden (image-hash, keypoint-hash) pair using Rust's
DefaultHasher (tests/compare.rs:5-20, 83-89).  That hash is not stable
across languages, so we use FNV-1a 64-bit over a canonical byte encoding —
stable across platforms, Python versions, and array libraries.  A copy of
``feature_detector_fast_tpu.utils.hashing``, whose package imports jax.
"""

from __future__ import annotations

import struct
from typing import Iterable, Tuple

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


def fnv1a(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK
    return h


def fnv1a_array(arr: np.ndarray) -> int:
    """FNV-1a over an array's canonical little-endian bytes."""
    a = np.ascontiguousarray(arr)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return fnv1a(a.tobytes())


def hash_image(image: np.ndarray) -> int:
    """Golden hash of a uint8 image (analogue of tests/compare.rs:13-20)."""
    return fnv1a_array(np.asarray(image, np.uint8))


def hash_keypoints(points: Iterable[Tuple[int, int]]) -> int:
    """Golden hash of an ordered keypoint list: each point contributes its
    (x, y) as two little-endian u32s (analogue of tests/compare.rs:5-12)."""
    buf = bytearray()
    for x, y in points:
        buf += struct.pack("<II", int(x), int(y))
    return fnv1a(bytes(buf))


def hash_features(xy, score, valid, desc, desc_valid) -> int:
    """Golden hash of one frame's front-end output (numpy-convertible
    arrays: xy (K, 2), score (K,), valid (K,), desc (K, WORDS) of 32-bit
    words, desc_valid (K,)).  Each valid slot, in slot order, contributes
    x, y, score, desc_valid and its WORDS descriptor words as little-endian
    u32s; the words of a slot whose descriptor is invalid count as zeros,
    since every route leaves garbage there."""
    valid = np.asarray(valid, bool)
    dvalid = np.asarray(desc_valid, bool)
    words = np.ascontiguousarray(np.asarray(desc)).view(np.uint32)
    rows = np.concatenate([
        np.asarray(xy).astype(np.uint32),
        np.asarray(score).astype(np.uint32)[:, None],
        dvalid.astype(np.uint32)[:, None],
        np.where(dvalid[:, None], words, 0).astype(np.uint32),
    ], axis=1)
    return fnv1a_array(rows[valid])
