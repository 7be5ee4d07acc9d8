"""Plain PyTorch versions of the OFF-floor experiment kernels (``csrc/exp_off.cu``).

Counterparts of the Pallas kernels of the JAX package's TPU experiment
tools, which measure what the OFF words kernel (``fdf_fast_words``) costs
stage by stage:

* :func:`floor_load`, :func:`floor_triple` and :func:`floor_prefilter` --
  floors of the OFF kernel (``tools/exp_off_floor.py``): ``LOAD``
  (``pallas-1in``, :81-95), ``TRIPLE`` (``pallas-3in``, :97-117) and
  ``PREFILTER`` (what ``pallas-win``, :119-140, was meant to measure: the
  window build plus the cardinal prefilter of
  ``fast_pallas._swar_window_prefilter``, fast_pallas.py:381-396);
* :func:`prepack` and :func:`words_prepacked` -- OFF words from a
  prepacked dual-row plane (``tools/exp_off_prepack.py``, :51-139);
* :func:`swar_pred16` and :func:`swar_pred8` -- the 16-tap dual-polarity
  predicate sequences in 16-bit and 8-bit fields
  (``tools/exp_off_byteswar.py``, ``k16`` :60-82 and ``k8`` :84-99).

Every floor and words function returns the kernel's layout: (B, H,
ceil(W/32)) int32 words, bit b of word j in row y for column 32*j + b
(``compact.pack_mask_words``).  The CPU path of ``ops/exp_off_cuda.py``
runs these functions, the tests hold them against the JAX tools' kernel
bodies, and on the card they are the kernels' yardstick.  :func:`prepack`
is not a kernel in the JAX tool either (it is XLA outside the
``pallas_call``): it is plain PyTorch on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry import CIRCLE, EAST, NORTH, RADIUS, SOUTH, WEST
from . import compact, fast, windows

LOAD, TRIPLE, PREFILTER = "load", "triple", "prefilter"

#: Rows of the JAX tools' tile (``fast_pallas.TILE_H``): the default TRIPLE
#: span and the prepack's tile height.
TILE_H = 128
#: Pixels to a lane of the JAX tools' padded width (``fast_pallas.LANES``).
LANES = 128
#: Packed rows per tile of the prepacked plane: a field's 64 centre rows,
#: the circle radius above and below, and 2 rows of slack (the JAX tool's
#: ``half + 2 * RADIUS + 2``; its docstring's "40" is stale).
PACKED_ROWS = TILE_H // 2 + 2 * RADIUS + 2

_I32 = torch.int32


def _i32c(v: int) -> int:
    """Python int -> the int32 with the same low 32 bits (wrapping)."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def _pad_to(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def need_for(count: int) -> int:
    """Cardinal taps one polarity must hit to pass the prefilter: 3 of 4 for
    count >= 12, else 2 (fast_pallas.py:385)."""
    return 3 if int(count) >= 12 else 2


def floor_load(images: torch.Tensor) -> torch.Tensor:
    """The ``LOAD`` floor of a (B, H, W) u8 batch: ``px & 1``, packed as
    (B, H, ceil(W/32)) int32 words."""
    return compact.pack_mask_words((images & 1).to(torch.bool))


def floor_triple(images: torch.Tensor, span: int = TILE_H) -> torch.Tensor:
    """The ``TRIPLE`` floor: ``(px(y - span) ^ px(y) ^ px(y + span)) & 1``,
    each outer row taken from the neighbouring ``span``-row block, clamped
    to the first and last block as the JAX kernel's ``clamp(i -+ 1)`` index
    maps are; a row past the frame in the last, partial block reads 0 (the
    JAX tool's zero padding)."""
    b, h, w = images.shape
    span = int(span)
    n_blk = -(-h // span)
    y = torch.arange(h, device=images.device)
    blk, r = y // span, y % span
    padded = F.pad(images, (0, 0, 0, n_blk * span - h))
    prev = padded[:, (blk - 1).clamp(0, n_blk - 1) * span + r]
    nxt = padded[:, (blk + 1).clamp(0, n_blk - 1) * span + r]
    return compact.pack_mask_words(((prev ^ images ^ nxt) & 1).to(torch.bool))


def prefilter_mask(images: torch.Tensor, threshold: int = 16, count: int = 9) -> torch.Tensor:
    """The cardinal prefilter as a bool (B, H, W) mask: at every pixel with
    x in [3, W-4] and y in [3, H-4], (at least ``need_for(count)`` of the 4
    cardinal taps bright) or (as many dark), compares strict in int32;
    False elsewhere."""
    b, h, w = images.shape
    t, need = int(threshold), need_for(count)
    x = images.to(_I32)
    taps = fast.circle_taps(images)
    card = [taps[i] for i in (NORTH, EAST, SOUTH, WEST)]
    nb = sum((p - x > t).to(_I32) for p in card)
    nd = sum((x - p > t).to(_I32) for p in card)
    return ((nb >= need) | (nd >= need)) & fast.interior_mask((h, w), images.device)


def floor_prefilter(images: torch.Tensor, threshold: int = 16, count: int = 9) -> torch.Tensor:
    """The ``PREFILTER`` floor: :func:`prefilter_mask`, packed."""
    return compact.pack_mask_words(prefilter_mask(images, threshold, count))


#: The floor stages by name (the tools' and the launch counters' names).
FLOORS = {LOAD: floor_load, TRIPLE: floor_triple, PREFILTER: floor_prefilter}


def prepack(images: torch.Tensor) -> torch.Tensor:
    """The JAX tool's prepacked dual-row plane of a (B, H, W) u8 batch:
    (B, n_tiles * PACKED_ROWS, wp) int32, with the frame zero-padded to
    (n_tiles * 128, wp) (wp = W rounded up to 128).  Packed row j of tile i
    holds padded row clamp(128 i + j - 3) in its low 16-bit field and
    padded row clamp(128 i + j - 3 + 64) in its high field, rows clamped to
    the padded frame (exp_off_prepack.py:51-71)."""
    b, h, w = images.shape
    hp, wp = _pad_to(h, TILE_H), _pad_to(w, LANES)
    imgp = F.pad(images, (0, wp - w, 0, hp - h))
    n_tiles = hp // TILE_H
    dev = images.device
    base = (torch.arange(n_tiles, device=dev)[:, None] * TILE_H
            + torch.arange(PACKED_ROWS, device=dev)[None, :] - RADIUS)
    lo = imgp[:, base.clamp(0, hp - 1).reshape(-1)].to(_I32)
    hi = imgp[:, (base + TILE_H // 2).clamp(0, hp - 1).reshape(-1)].to(_I32)
    return lo | (hi << 16)


def words_prepacked(plane: torch.Tensor, threshold: int, count: int, *, height: int,
                    width: int) -> torch.Tensor:
    """OFF keypoint words of the frames a (B, n_tiles * PACKED_ROWS, wp)
    :func:`prepack` plane holds, (B, height, ceil(width/32)) int32: equal
    to the OFF words of the frames themselves.

    Each 16-bit field is read as a u8 pixel (its low byte, which is all
    :func:`prepack` puts there).  Field f of tile i has its centre rows at
    packed rows 3..66 (frame rows 128 i + 64 f + r) and its circle taps in
    the same field, 3 rows up or down."""
    b, rows, wp = plane.shape
    n_tiles = rows // PACKED_ROWS
    half = TILE_H // 2
    f = plane.reshape(b, n_tiles, PACKED_ROWS, wp)
    fields = torch.stack([f & 0xFF, (f >> 16) & 0xFF], dim=2)  # (B, n_tiles, 2, 72, wp)
    c = fields[..., RADIUS:RADIUS + half, :]
    padded = F.pad(fields, (RADIUS, RADIUS))
    t = int(threshold)
    taps = [padded[..., RADIUS + dy:RADIUS + dy + half, RADIUS + dx:RADIUS + dx + wp]
            for dx, dy in CIRCLE]
    bright = [p - c > t for p in taps]
    dark = [c - p > t for p in taps]
    arc = (windows.ring_any_window_all(bright, int(count), torch.logical_and, torch.logical_or)
           | windows.ring_any_window_all(dark, int(count), torch.logical_and, torch.logical_or))
    keep = arc.reshape(b, n_tiles * TILE_H, wp)[:, :height, :width]
    return compact.pack_mask_words(keep & fast.interior_mask((height, width), plane.device))


#: 16-bit-field broadcast factor, and the byte-field masks, of the SWAR
#: predicate sequences.
_FF = 0x00010001
_M9 = _i32c(0x200 * _FF)
_H8 = _i32c(0x80808080)
_L7 = 0x7F7F7F7F
TAPS = 16


def swar_pred16(x: torch.Tensor, hb: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """The 16-bit-field predicate sequence ``k16`` (exp_off_byteswar.py:60-82)
    over int32 planes, op for op: per tap, ``p + hb`` and ``cw - p`` with
    bit 9 of each field moved to bit k, OR-accumulated per polarity;
    ``p + 1`` between taps.  Adds and shifts wrap as JAX's int32 ops do."""
    p = x
    bright = torch.zeros_like(x)
    dark = torch.zeros_like(x)
    for k in range(TAPS):
        q = p + hb
        r = cw - p
        s = 9 - k
        if s > 0:
            b = (q >> s) & _i32c(_FF << k)
            d = (r >> s) & _i32c(_FF << k)
        elif s == 0:
            b = q & _M9
            d = r & _M9
        else:
            b = (q << (-s)) & _i32c(_FF << k)
            d = (r << (-s)) & _i32c(_FF << k)
        bright = bright | b
        dark = dark | d
        p = p + 1
    return bright ^ dark


def swar_pred8(x: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The 8-bit-field predicate sequence ``k8`` (exp_off_byteswar.py:84-99)
    over int32 planes, op for op: per tap a bytewise unsigned ``hi < p``
    (bright) and ``p < lo`` (dark), the sign bit of each byte moved to bit
    k % 8 and OR-accumulated into plane k // 8; ``p + 0x01010101`` between
    taps.  The subtraction overflows int32 and wraps, as in JAX."""
    p = x
    planes = [torch.zeros_like(x), torch.zeros_like(x)]
    for k in range(TAPS):
        for a, b in ((hi, p), (p, lo)):
            w = ((a & _L7) | _H8) - (b & _L7)
            r = ((~a & b) | (~(a ^ b) & ~w)) & _H8
            s = 7 - (k % 8)
            bit = (r >> s) & _i32c(0x01010101 << (k % 8)) if s else r
            planes[k // 8] = planes[k // 8] | bit
        p = p + 0x01010101
    return planes[0] ^ planes[1]
