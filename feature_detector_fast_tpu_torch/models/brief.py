"""BRIEF-256 binary descriptors: top-K keypoints, then sparse, dense or
patched description.

Counterpart of ``feature_detector_fast_tpu.models.brief``.  The sampling
pattern and its steered tables are built with numpy from the same seed and
the same code, so they equal the JAX package's arrays; they are the
front-end's only fixed parameters.  Every function takes frames with any
leading batch shape, ``(..., H, W)`` u8, and keypoints with the same
leading shape, ``(..., K, 2)``: the batch is a leading dimension, not a
vmap.

Descriptors are ``(..., K, WORDS)`` int32 bit patterns (bit b of word j is
pattern pair 32j + b); the JAX package's are uint32.  View them as
``np.uint32`` at the host boundary.  Slots whose keypoint is invalid or
closer than ``BORDER`` to an edge carry a False validity bit and
route-dependent garbage, as in every JAX route.

Routes, all bit-identical at valid slots:
  * :func:`describe` / :func:`describe_oriented` -- the sparse K x 512
    gather from the blurred frame; the CPU path and the yardstick;
  * :func:`describe_dense` -- every pixel's words from the dense kernel
    (``ops/brief_cuda.py``), then a K x WORDS gather;
  * :func:`describe_patched` -- each keypoint's 31 x 31 blurred window from
    the patch kernel (``ops/patch_cuda.py``), then an exact integer gather
    of the pattern (or of its rotation for the keypoint's orientation bin)
    from the window.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

#: Descriptor length in bits and packed 32-bit words.
BITS = 256
WORDS = BITS // 32

#: Patch half-size: pattern offsets lie in [-PATCH_R, PATCH_R].
PATCH_R = 15
#: Keypoints closer than this to the border get invalid descriptors
#: (pattern + smoothing halo).
BORDER = PATCH_R + 3


def _make_pattern(seed: int = 0x1EAF) -> np.ndarray:
    """(BITS, 2, 2) int32 array of (dx, dy) pairs, Gaussian sigma = R/2,
    clipped to the patch."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH_R / 2.0, size=(BITS, 2, 2))
    return np.clip(np.round(pts), -PATCH_R, PATCH_R).astype(np.int32)


PATTERN: np.ndarray = _make_pattern()

#: Orientation quantization for steered (rotation-aware) BRIEF.
N_ANGLE_BINS = 30


def _quadrant_decomposition():
    """Each orientation bin's angle is 90 deg * q + rho with rho in
    (-45, 45]; the 30 bins share 15 distinct residuals.

    Returns (quadrant (N_ANGLE_BINS,), residual_bin (N_ANGLE_BINS,),
    residual_angles_deg (N_RESIDUAL,))."""
    qs, rbs, residuals = [], [], []
    for b in range(N_ANGLE_BINS):
        theta = 360.0 * b / N_ANGLE_BINS
        q = int(round(theta / 90.0)) % 4
        rho = round(theta - 90.0 * round(theta / 90.0), 9)
        if rho not in residuals:
            residuals.append(rho)
        qs.append(q)
        rbs.append(residuals.index(rho))
    return (np.asarray(qs, np.int32), np.asarray(rbs, np.int32),
            np.asarray(residuals, np.float64))


QUADRANT, RESIDUAL_BIN, _RESIDUAL_ANGLES = _quadrant_decomposition()
N_RESIDUAL_BINS = len(_RESIDUAL_ANGLES)


def _rot90_points(q: int, x: np.ndarray, y: np.ndarray):
    """Rotate integer points by 90 deg * q (exact)."""
    for _ in range(q % 4):
        x, y = -y, x
    return x, y


def _make_residual_patterns() -> np.ndarray:
    """(N_RESIDUAL_BINS, BITS, 2, 2) int32: the base pattern rotated to
    each residual angle (rounded to the pixel grid, clipped to the patch)."""
    out = np.zeros((N_RESIDUAL_BINS, BITS, 2, 2), np.int32)
    x = PATTERN[..., 0]
    y = PATTERN[..., 1]
    for r, ang in enumerate(_RESIDUAL_ANGLES):
        a = np.deg2rad(ang)
        c, s = np.cos(a), np.sin(a)
        out[r, ..., 0] = np.clip(np.round(c * x - s * y), -PATCH_R, PATCH_R)
        out[r, ..., 1] = np.clip(np.round(s * x + c * y), -PATCH_R, PATCH_R)
    return out


RESIDUAL_PATTERNS: np.ndarray = _make_residual_patterns()


def _make_rotated_patterns() -> np.ndarray:
    """(N_ANGLE_BINS, BITS, 2, 2) int32: the steered-BRIEF table, defined
    as the 90-degree isometries of the residual tables (the JAX package's
    canonical table)."""
    out = np.zeros((N_ANGLE_BINS, BITS, 2, 2), np.int32)
    for b in range(N_ANGLE_BINS):
        rp = RESIDUAL_PATTERNS[RESIDUAL_BIN[b]]
        x, y = _rot90_points(int(QUADRANT[b]), rp[..., 0], rp[..., 1])
        out[b, ..., 0] = x
        out[b, ..., 1] = y
    return out


ROTATED_PATTERNS: np.ndarray = _make_rotated_patterns()

#: The describe routes' crossover on a 1080p frame, scaled to any frame by
#: its pixels (:func:`_dense_k_min`).  The patched route costs ~1.5e-5 ms
#: per keypoint per frame, the dense one ~0.077 ms per 1080p frame and grows
#: with the pixels, so the crossover is a density.  On an NVIDIA H100 80GB
#: HBM3 at 700 W, at (16, 1080, 1920), SumAbsolute t=16 n=9,
#: tools/descriptor_bench.py measured 0.0712 vs 0.0777 at k=4096 and 0.1021
#: vs 0.0761 at k=6144, ms per frame; the routes cross at k=4400-4530 in
#: three runs.  At (16, 2160, 3840) they cross at k=17600-17800 (scaled:
#: 18000); at (16, 480, 640) both cost 0.015-0.018 ms a frame from k=148
#: to 607 and the dense one wins from k=910 (scaled: 666) (PERF.md).
_DENSE_K_MIN_1080P = 4500


def _dense_k_min(h: int, w: int) -> int:
    """The most keypoints a frame of h x w pixels that a CUDA batch
    describes by the patch kernel; above it the dense kernel runs."""
    return _DENSE_K_MIN_1080P * h * w // (1080 * 1920)


_PATCH = 2 * PATCH_R + 1  # rows/cols of a descriptor patch


def _boxsum_chain(x: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)-square box sum over the last two dims, zero-padded at the
    borders, exact: int64 prefix sums, cast to int32 at the end (which
    wraps exactly as the JAX package's int32 adds would)."""
    n = 2 * r + 1

    def box1d(v: torch.Tensor, dim: int) -> torch.Tensor:
        m = v.shape[dim]
        shape = list(v.shape)
        shape[dim] = r + 1
        head = v.new_zeros(shape)
        shape[dim] = r
        c = torch.cumsum(torch.cat([head, v, v.new_zeros(shape)], dim), dim)
        return c.narrow(dim, n, m) - c.narrow(dim, 0, m)

    x = x.to(torch.int64)
    return box1d(box1d(x, x.dim() - 2), x.dim() - 1).to(torch.int32)


def box_blur5(image: torch.Tensor) -> torch.Tensor:
    """5x5 box SUM (not divided: BRIEF only compares) of (..., H, W) u8
    frames, int32, with the JAX package's edge rule: the sums replicate
    outwards, so ``blur(y, x) = S5x5(clamp(y, 2, H-3), clamp(x, 2, W-3))``.
    Needs H, W >= 5."""
    h, w = image.shape[-2:]
    if h < 5 or w < 5:
        raise ValueError(f"image too small for the 5x5 blur: {h}x{w}")
    x = image.to(torch.int32)

    def box1d(v: torch.Tensor, dim: int) -> torch.Tensor:
        n = v.shape[dim]
        inner = sum(v.narrow(dim, d, n - 4) for d in range(5))
        centre = (torch.arange(n, device=v.device) - 2).clamp(0, n - 5)
        return inner.index_select(dim, centre)

    return box1d(box1d(x, x.dim() - 2), x.dim() - 1)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (static shape, on the frames' device)."""

    xy: torch.Tensor  # (..., K, 2) int32 -- (x, y); undefined where ~valid
    score: torch.Tensor  # (..., K) int32
    valid: torch.Tensor  # (..., K) bool


def _topk_key(mask: torch.Tensor, score: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Packed (clipped score, reversed row-major index) int31 selection key
    per pixel, (..., H*W), -1 where masked: ties break toward the smaller
    index.  The score clip uses the bits the index leaves (1023 at 1080p)."""
    h, w = mask.shape[-2:]
    n = h * w
    idx_bits = max(1, (n - 1).bit_length())
    if idx_bits > 29:
        raise ValueError(f"image too large for top-k key packing: {h}x{w}")
    max_score = (1 << (31 - idx_bits)) - 1
    lead = mask.shape[:-2]
    flat_mask = mask.reshape(*lead, n).to(torch.bool)
    flat_score = torch.clamp(score.reshape(*lead, n).to(torch.int32), max=max_score)
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    key = torch.where(flat_mask, (flat_score << idx_bits) | (n - 1 - idx), -1)
    return key, idx_bits


def _decode_topk(topv: torch.Tensor, idx_bits: int, h: int, w: int,
                 score: torch.Tensor) -> Keypoints:
    """Unpack selected keys to Keypoints; scores are regathered exactly from
    the score plane (the key's score field is clipped)."""
    valid = topv >= 0
    sel = torch.where(valid, h * w - 1 - (topv & ((1 << idx_bits) - 1)), 0)
    flat_score = score.reshape(*score.shape[:-2], h * w).to(torch.int32)
    s = torch.where(valid, flat_score.gather(-1, sel.long()), 0)
    return Keypoints(torch.stack([sel % w, sel // w], dim=-1), s, valid)


def select_topk(mask: torch.Tensor, score: torch.Tensor, k: int) -> Keypoints:
    """Deterministic top-K keypoints by (score clipped as in _topk_key, then
    row-major position) of (..., H, W) mask and score planes.

    One ``torch.topk`` over every pixel's key: the JAX package's two-level
    grouping is a TPU device that is provably identical to this flat form
    (its ``_select_topk_flat``).  Slots past the number of keypoints are
    (0, 0), score 0, invalid."""
    h, w = mask.shape[-2:]
    key, idx_bits = _topk_key(mask, score)
    k = int(k)
    topv = torch.topk(key, min(k, h * w), dim=-1).values
    if k > h * w:
        pad = torch.full((*topv.shape[:-1], k - h * w), -1, dtype=topv.dtype,
                         device=topv.device)
        topv = torch.cat([topv, pad], dim=-1)
    return _decode_topk(topv, idx_bits, h, w, score)


def _frames(images: torch.Tensor, kps: Keypoints):
    """(N, H, W) frames, (N, K, 2) coordinates, (N, K) validity and the
    leading shape to restore."""
    lead = images.shape[:-2]
    h, w = images.shape[-2:]
    imgs = images.reshape(-1, h, w)
    n = imgs.shape[0]
    return imgs, kps.xy.reshape(n, -1, 2).to(torch.int32), kps.valid.reshape(n, -1), lead


def _in_border(xy: torch.Tensor, valid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    x, y = xy[..., 0], xy[..., 1]
    return valid & (x >= BORDER) & (x < w - BORDER) & (y >= BORDER) & (y < h - BORDER)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., BITS) bool -> (..., WORDS) int32, bit b of word j = bit 32j+b.
    The bits are distinct powers of two, so their int32 sum is their OR
    (bit 31 lands on the sign bit)."""
    g = bits.reshape(*bits.shape[:-1], WORDS, 32).to(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    return (g << shifts).sum(dim=-1, dtype=torch.int32)


def _endpoint_major(pats: np.ndarray, pitch: int) -> np.ndarray:
    """(..., BITS, 2, 2) (dx, dy) pairs -> (..., 2 * BITS) flat offsets
    dy * pitch + dx: all first endpoints, then all second endpoints."""
    off = pats[..., 1].astype(np.int64) * pitch + pats[..., 0]
    return np.concatenate([off[..., 0], off[..., 1]], axis=-1)


@functools.lru_cache(maxsize=None)
def _table(name: str, pitch: int, device: torch.device) -> torch.Tensor:
    """Sampling offsets of PATTERN ("plain", (2*BITS,)) or of
    ROTATED_PATTERNS ("rotated", (N_ANGLE_BINS, 2*BITS)) at a row pitch,
    int64, cached per device."""
    pats = PATTERN if name == "plain" else ROTATED_PATTERNS
    return torch.as_tensor(_endpoint_major(pats, pitch), device=device)


def _sample(blur: torch.Tensor, base: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Pack ``blur[base + o1] < blur[base + o2]`` per pattern pair: blur
    (N, P) int32, base (N, K), off (2*BITS,) or (N, K, 2*BITS) indices into
    the flattened blur."""
    n = blur.shape[0]
    idx = (base[..., None].long() + off).clamp_(0, blur.shape[1] - 1)
    s = blur.gather(1, idx.reshape(n, -1)).reshape(idx.shape)
    return _pack_bits(s[..., :BITS] < s[..., BITS:])


def _sparse(imgs: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
            off: torch.Tensor, lead) -> Tuple[torch.Tensor, torch.Tensor]:
    n, h, w = imgs.shape
    inb = _in_border(xy, valid, h, w)
    base = torch.where(inb, xy[..., 1] * w + xy[..., 0], 0)
    desc = _sample(box_blur5(imgs).reshape(n, h * w), base, off)
    return desc.reshape(*lead, -1, WORDS), inb.reshape(*lead, -1)


def describe(images: torch.Tensor, kps: Keypoints) -> Tuple[torch.Tensor, torch.Tensor]:
    """BRIEF-256 by the sparse gather from the blurred frames.

    Returns (desc (..., K, WORDS) int32, valid (..., K) bool); valid is
    False for slots whose patch leaves the image."""
    imgs, xy, valid, lead = _frames(images, kps)
    off = _table("plain", imgs.shape[-1], imgs.device)
    return _sparse(imgs, xy, valid, off, lead)


def _bins(m10: torch.Tensor, m01: torch.Tensor) -> torch.Tensor:
    """Orientation bin of integer moments, in the JAX package's float32
    steps: round(atan2(m01, m10) / 2pi * N_ANGLE_BINS), half to even, mod
    N_ANGLE_BINS.  The divisor is a tensor so that every device divides
    (a scalar divisor becomes a reciprocal multiply on CUDA)."""
    angle = torch.atan2(m01.to(torch.float32), m10.to(torch.float32))
    two_pi = torch.full_like(angle, 2.0 * math.pi)
    bins = torch.round(angle / two_pi * N_ANGLE_BINS).to(torch.int32)
    return torch.remainder(bins, N_ANGLE_BINS)


def orientation_bins(images: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    """Intensity-centroid orientation bin per keypoint, (..., K) int32.

    The patch moments m10 = sum I(x, y)(x - xc) and m01 over the
    (2R+1)-square patch come from three dense box sums (of I*x, I*y, I),
    sampled at the keypoints, in exact int32 arithmetic."""
    imgs, xy, _, lead = _frames(images, kps)
    return _orientation_bins(imgs, xy).reshape(*lead, -1)


def _orientation_bins(imgs: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """orientation_bins of (N, H, W) frames at (N, K, 2) coordinates."""
    n, h, w = imgs.shape
    img = imgs.to(torch.int32)
    xs = torch.arange(w, dtype=torch.int32, device=img.device)
    ys = torch.arange(h, dtype=torch.int32, device=img.device)[:, None]
    s_i = _boxsum_chain(img, PATCH_R)
    s_ix = _boxsum_chain(img * xs, PATCH_R)
    s_iy = _boxsum_chain(img * ys, PATCH_R)

    kx, ky = xy[..., 0], xy[..., 1]
    at = (ky * w + kx).clamp(0, h * w - 1).long()

    def flat(m: torch.Tensor) -> torch.Tensor:
        return m.reshape(n, h * w).gather(1, at)

    return _bins(flat(s_ix) - kx * flat(s_i), flat(s_iy) - ky * flat(s_i))


def describe_oriented(images: torch.Tensor, kps: Keypoints) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steered BRIEF-256 (ORB style) by the sparse gather: each keypoint
    samples ROTATED_PATTERNS[its orientation bin].  Same return contract as
    :func:`describe`."""
    imgs, xy, valid, lead = _frames(images, kps)
    off = _table("rotated", imgs.shape[-1], imgs.device)[_orientation_bins(imgs, xy).long()]
    return _sparse(imgs, xy, valid, off, lead)


def describe_dense(images: torch.Tensor, kps: Keypoints) -> Tuple[torch.Tensor, torch.Tensor]:
    """BRIEF-256 from every pixel's descriptor words (the dense kernel,
    ``ops/brief_cuda.describe_words``), then a K x WORDS gather.
    Bit-identical to :func:`describe` at every valid slot."""
    from ..ops import brief_cuda

    imgs, xy, valid, lead = _frames(images, kps)
    inb = _in_border(xy, valid, *imgs.shape[-2:])
    desc = brief_cuda.gather_descriptors(brief_cuda.describe_words(imgs), xy, inb)
    return desc.reshape(*lead, -1, WORDS), inb.reshape(*lead, -1)


@functools.lru_cache(maxsize=None)
def _moment_weights(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dy) of each cell of a flattened 31 x 31 patch, int32."""
    d = torch.arange(-PATCH_R, PATCH_R + 1, dtype=torch.int32, device=device)
    return d.repeat(_PATCH), d.repeat_interleave(_PATCH)


def describe_patched(images: torch.Tensor, kps: Keypoints,
                     oriented: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """BRIEF-256, plain or steered, from per-keypoint windows.

    The patch kernel (``ops/patch_cuda.extract_windows_fused``) gives each
    keypoint's 31 x 31 window of the 5x5 box sum with the raw pixel in bits
    13 and up.  For the steered form the raw pixels give the moments
    (m10 = sum raw * dx, m01 = sum raw * dy, exact int32, equal to
    :func:`orientation_bins`'s at valid slots) and so the bin.  The pattern
    -- PATTERN, or ROTATED_PATTERNS[bin], which the JAX package defines as
    the isometries its patched path applies -- is then gathered from the
    window as exact integers: no matmul, no rounding.  Bit-identical to
    :func:`describe` / :func:`describe_oriented` at every valid slot."""
    from ..ops import patch_cuda

    imgs, xy, valid, lead = _frames(images, kps)
    n, h, w = imgs.shape
    inb = _in_border(xy, valid, h, w)
    wins = patch_cuda.extract_windows_fused(imgs, xy).reshape(n, -1, _PATCH * _PATCH)
    blur = (wins & ((1 << patch_cuda.RAW_SHIFT) - 1)).reshape(n, -1)
    if oriented:
        raw = wins >> patch_cuda.RAW_SHIFT
        dx, dy = _moment_weights(imgs.device)
        bins = _bins((raw * dx).sum(-1), (raw * dy).sum(-1))
        off = _table("rotated", _PATCH, imgs.device)[bins.long()]
    else:
        off = _table("plain", _PATCH, imgs.device)
    # Window k starts at flat index k * 961 of the flattened windows; its
    # centre is cell (15, 15).
    k = wins.shape[1]
    base = torch.arange(k, device=imgs.device) * (_PATCH * _PATCH) + PATCH_R * (_PATCH + 1)
    desc = _sample(blur, base.expand(n, k), off)
    return desc.reshape(*lead, -1, WORDS), inb.reshape(*lead, -1)


def detect_and_describe_batch(
    images, threshold: int, count: int, k: int, oriented: bool = False, *,
    device="cuda",
) -> Tuple[Keypoints, torch.Tensor, torch.Tensor]:
    """Front-end step for a (B, H, W) u8 batch (numpy array or tensor):
    FAST SumAbsolute scores -> top-K -> BRIEF.

    ``device`` is "cuda" (the default; raises without CUDA) or "cpu".  On
    the CPU the sparse gathers run (:func:`describe`,
    :func:`describe_oriented`), as the JAX package runs them off the TPU.
    On CUDA, oriented calls and k <= ``_dense_k_min(H, W)`` take the patch
    kernel, larger k the dense kernel.  Returns (Keypoints (B, K), desc (B, K,
    WORDS) int32, desc_valid (B, K) bool)."""
    from ..api import _as_images
    from ..config import NonmaxMode
    from ..ops import fast_cuda

    imgs = _as_images(images, 3, device)
    mask, score = fast_cuda.detect_dense(imgs, threshold, count, NonmaxMode.SUM_ABSOLUTE)
    kps = select_topk(mask, score, k)
    return (kps, *describe_best(imgs, kps, oriented))


def describe_best(images: torch.Tensor, kps: Keypoints,
                  oriented: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """BRIEF-256 by the route for the frames' device: on the CPU the sparse
    gathers (:func:`describe`, :func:`describe_oriented`); on CUDA the
    patch kernel for steered calls and K <= :func:`_dense_k_min` of the
    frame size, the dense kernel above.  All routes agree at every valid
    slot."""
    if images.device.type == "cpu":
        return (describe_oriented if oriented else describe)(images, kps)
    if oriented or kps.xy.shape[-2] <= _dense_k_min(*images.shape[-2:]):
        return describe_patched(images, kps, oriented)
    return describe_dense(images, kps)


def detect_and_describe(
    image, threshold: int, count: int, k: int, oriented: bool = False, *,
    device="cuda",
) -> Tuple[Keypoints, torch.Tensor, torch.Tensor]:
    """:func:`detect_and_describe_batch` for one (H, W) frame: Keypoints
    (K,), desc (K, WORDS) int32, desc_valid (K,)."""
    from ..api import _as_images

    img = _as_images(image, 2, device)
    kps, desc, dvalid = detect_and_describe_batch(img[None], threshold, count, k, oriented,
                                                  device=img.device)
    return Keypoints(*(f[0] for f in kps)), desc[0], dvalid[0]
