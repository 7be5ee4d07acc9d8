"""The plain versions of the OFF-floor experiment kernels, on the CPU,
against the JAX package's TPU experiment tools.

The tools' Pallas kernel bodies are closures inside their ``main()``, so
each is restated here from the tool (file:line cited) and run through
``pl.pallas_call(..., interpret=True)``, as tests/test_pallas.py runs the
package's kernels.  The same seeded numpy inputs go through both sides.
Every output is an integer plane, so every comparison is exact: the
tolerance is zero.
"""

import ctypes
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from feature_detector_fast_tpu.config import NonmaxMode as JaxNonmaxMode
from feature_detector_fast_tpu.geometry import RADIUS
from feature_detector_fast_tpu.ops import fast_pallas as fp
from feature_detector_fast_tpu_torch.config import NonmaxMode
from feature_detector_fast_tpu_torch.ops import exp_off, exp_off_cuda, fast_cuda

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "feature_detector_fast_tpu_torch",
                    "csrc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker (see tests/test_torch_fast.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unpack(words: torch.Tensor) -> np.ndarray:
    """(B, H, n_words) int32 words -> (B, H, 32 * n_words) bool bits."""
    w = words.numpy().view(np.uint32)
    bits = (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(*w.shape[:-1], -1).astype(bool)


def padded(img: np.ndarray, tile_h: int) -> jax.Array:
    h, w = img.shape
    return jnp.pad(jnp.asarray(img), ((0, -h % tile_h), (0, -w % fp.LANES)))


def jax_load(img: np.ndarray, tile_h: int = fp.TILE_H) -> np.ndarray:
    """tools/exp_off_floor.py ``pallas-1in``: body ``k1`` (:81-82), call
    (:84-94); (hp, 128) int32."""
    x = padded(img, tile_h)
    hp, wp = x.shape

    def k1(img_ref, out_ref):
        out_ref[:, :] = (img_ref[:, :128] & 1).astype(jnp.int32)

    return np.asarray(pl.pallas_call(
        k1, grid=(hp // tile_h,),
        in_specs=[pl.BlockSpec((tile_h, wp), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((tile_h, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((hp, 128), jnp.int32),
        interpret=True,
    )(x))


def jax_triple(img: np.ndarray, tile_h: int = fp.TILE_H) -> np.ndarray:
    """tools/exp_off_floor.py ``pallas-3in``: body ``k3`` (:97-99), call
    (:101-116), given ``(x, x, x)`` for its three in_specs (the tool passes
    one input, which pallas_call refuses); (hp, 128) int32."""
    x = padded(img, tile_h)
    hp, wp = x.shape
    n_tiles = hp // tile_h
    clamp = lambda v: jnp.clip(v, 0, n_tiles - 1)

    def k3(p_ref, c_ref, n_ref, out_ref):
        out_ref[:, :] = ((p_ref[:, :128] ^ c_ref[:, :128] ^ n_ref[:, :128])
                         & 1).astype(jnp.int32)

    return np.asarray(pl.pallas_call(
        k3, grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((tile_h, wp), lambda i: (clamp(i - 1), 0)),
            pl.BlockSpec((tile_h, wp), lambda i: (i, 0)),
            pl.BlockSpec((tile_h, wp), lambda i: (clamp(i + 1), 0)),
        ],
        out_specs=pl.BlockSpec((tile_h, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((hp, 128), jnp.int32),
        interpret=True,
    )(x, x, x))


@pytest.mark.parametrize("shape", [(2, 300, 150), (1, 45, 100)])
def test_load_matches_pallas_1in(rng, shape):
    """LOAD == ``k1`` on columns [0, 128) of rows [0, H); 0 past the frame."""
    imgs = rng.integers(0, 256, shape, np.uint8)
    bits = unpack(exp_off.floor_load(torch.from_numpy(imgs)))
    h, w = shape[1:]
    for i, img in enumerate(imgs):
        want = jax_load(img)[:h]
        np.testing.assert_array_equal(bits[i, :, :128], want.astype(bool))
        assert not bits[i, :, w:].any()


@pytest.mark.parametrize("span", [128, 8])
@pytest.mark.parametrize("shape", [(1, 300, 150), (2, 53, 130), (1, 256, 131)])
def test_triple_matches_pallas_3in(rng, shape, span):
    """TRIPLE at span 128 (the tool's tile) and 8 == ``k3`` with that tile
    height: outer rows clamped to the first and last block, the partial
    last block's padding read as 0."""
    imgs = rng.integers(0, 256, shape, np.uint8)
    bits = unpack(exp_off.floor_triple(torch.from_numpy(imgs), span))
    h = shape[1]
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(bits[i, :, :128], jax_triple(img, span)[:h].astype(bool))


# The streaming LOAD and TRIPLE kernels of csrc/exp_off.cu (namespace
# stream), restated in numpy over whole warps: the 16-byte chunk path
# (W % 16 == 0, aligned base) with its multiply pack and warp shuffles, the
# element path, and TRIPLE's chain walk in segments.
def low_bits4(v: np.ndarray) -> np.ndarray:
    """((v & 0x01010101) * 0x01020408) >> 24 in uint32: the 4 low bits of
    v's bytes, byte j to bit j."""
    v = v.astype(np.uint64)
    return (((v & 0x01010101) * 0x01020408) & 0xFFFFFFFF) >> 24


def low_bits16(chunks: np.ndarray) -> np.ndarray:
    """(..., 16) u8 chunks -> their 16 low bits, byte j to bit j, 4 bytes
    (one little-endian uint32) at a time."""
    v = np.ascontiguousarray(chunks).view("<u4")
    return (low_bits4(v[..., 0]) | low_bits4(v[..., 1]) << 4 | low_bits4(v[..., 2]) << 8
            | low_bits4(v[..., 3]) << 12)


def run_words(run: np.ndarray, width: int, chunked: bool) -> np.ndarray:
    """The words of a run of rows (flat u8, whole rows of ``width``), as the
    kernel's warps make them: warp w takes words [32 w, 32 w + 32), lanes
    past the run's end make 0; uint64 words."""
    nw = -(-width // 32)
    n_words = run.size // width * nw
    t0 = np.arange(0, n_words, 32, dtype=np.int64)[:, None]
    lane = np.arange(32, dtype=np.int64)[None, :]
    t = t0 + lane
    n = np.minimum(32, n_words - t0)  # (tiles, 1)
    r, c = t // nw, t % nw
    if not chunked:  # element loads, the ragged last word zero-filled
        cols = 32 * c[..., None] + np.arange(32)
        inside = (cols < width) & (t < n_words)[..., None]
        px = np.where(inside, run[np.where(inside, r[..., None] * width + cols, 0)], 0)
        w = ((px.astype(np.uint64) & 1) << np.arange(32, dtype=np.uint64)).sum(-1)
        return w.reshape(-1)[:n_words]
    cw = width // 16
    chunks = run.reshape(-1, 16)
    if cw % 2 == 0:
        first, s, two = 2 * t0, np.broadcast_to(2 * lane, t.shape), np.ones(t.shape, bool)
    else:
        f = r * cw + 2 * c
        first, s, two = f[:, :1], f - f[:, :1], 2 * c + 1 < cw
    e = np.take_along_axis(s + two, n - 1, axis=1)  # the warp's last chunk, from first

    def lane_chunks(off: int) -> np.ndarray:
        ok = lane + off <= e
        idx = np.where(ok, first + lane + off, 0)
        return np.where(ok, low_bits16(chunks[idx]), 0)

    v = lane_chunks(0) | lane_chunks(32) << 16  # lane i: chunk i low, chunk i + 32 high
    a = np.take_along_axis(v, s & 31, axis=1)
    b = np.take_along_axis(v, (s + 1) & 31, axis=1)
    lo = np.where(s < 32, a & 0xFFFF, a >> 16)
    hi = np.where(~two, 0, np.where(s + 1 < 32, (b << 16) & 0xFFFFFFFF, b & 0xFFFF0000))
    return np.where(lane < n, lo | hi, 0).reshape(-1)[:n_words]


def as_words(w: np.ndarray, shape) -> torch.Tensor:
    return torch.from_numpy(w.astype(np.uint32).view(np.int32).reshape(shape))


def stream_constants() -> dict:
    src = read_source("exp_off.cu")
    body = src[src.index("namespace stream {"):src.index("}  // namespace stream")]
    consts = dict(re.findall(r"constexpr (?:int|long long) (\w+) = ([^;]+);", body))
    return {name: eval(consts[name].replace("LL", "").replace("/", "//"), {"__builtins__": {}})
            for name in ("FILL_WARPS", "MIN_STEPS")}


def triple_segment_steps(b: int, h: int, w: int, span: int) -> int:
    """launch_triple's segment length: enough chains to fill the card, none
    shorter than MIN_STEPS blocks."""
    k = stream_constants()
    n_blk = -(-h // span)
    chains = b * -(-min(span, h) * -(-w // 32) // 32)
    cuts = max(min(-(-k["FILL_WARPS"] // chains), -(-n_blk // k["MIN_STEPS"])), 1)
    return -(-n_blk // cuts)


def triple_walk(imgs: np.ndarray, span: int, chunked: bool, seg_steps: int):
    """TRIPLE as the kernel walks it: per frame, the packed words L(k) of
    each span-row block k (rows k * span + r, r < min(span, H)), then each
    segment [k0, k1) of the chain keeps (prev, cur, next) in three words --
    block 0's prev and the last block's next are the block itself, a row of
    the next block past H packs to 0.  Returns the words and the blocks each
    segment read."""
    bn, h, w = imgs.shape
    nw = -(-w // 32)
    n_blk = -(-h // span)
    held = min(span, h) * nw
    out = np.zeros((bn, h * nw), np.uint64)
    reads = []
    for i, img in enumerate(imgs):
        blocks = [np.pad(run_words(img[k * span:(k + 1) * span].reshape(-1), w, chunked),
                         (0, held - min(span, h - k * span) * nw)) for k in range(n_blk)]
        for k0 in range(0, n_blk, seg_steps):
            k1 = min(k0 + seg_steps, n_blk)
            read = set()

            def load(k):
                read.add(k)
                return blocks[k]

            cur = load(k0)
            prev = load(k0 - 1) if k0 > 0 else cur
            for k in range(k0, k1):
                nxt = load(k + 1) if k + 1 < n_blk else cur
                rows = min(span, h - k * span) * nw
                out[i, k * span * nw:k * span * nw + rows] = (prev ^ cur ^ nxt)[:rows]
                prev, cur = cur, nxt
            reads.append(sorted(read))
    return as_words(out, (bn, h, nw)), reads


WIDTHS = [9, 16, 48, 131, 150, 1931]


@pytest.mark.parametrize("width", WIDTHS)
def test_load_matches_stream_restatement(rng, width):
    """LOAD == the streaming kernel restated: the batch as one run of words,
    packed by the multiply on 4 bytes at a time from 16-byte chunks gathered
    by warp shuffles (W % 16 == 0) or by element loads (every width)."""
    imgs = rng.integers(0, 256, (3, 37, width), np.uint8)
    want = exp_off.floor_load(torch.from_numpy(imgs))
    for chunked in (True, False) if width % 16 == 0 else (False,):
        got = as_words(run_words(imgs.reshape(-1), width, chunked), want.shape)
        assert torch.equal(got, want), chunked


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("span, height", [(1, 13), (3, 37), (8, 61), (128, 301), (45, 45),
                                          (91, 45)])
def test_triple_matches_stream_restatement(rng, width, span, height):
    """TRIPLE == the chain walk restated, on heights that are not a multiple
    of the span (and span >= H), at the kernel's segment length and at
    segments of 1, 2 and the whole chain.  Each segment reads its blocks
    plus one at each end, so the whole chain reads every block once."""
    imgs = rng.integers(0, 256, (2, height, width), np.uint8)
    want = exp_off.floor_triple(torch.from_numpy(imgs), span)
    n_blk = -(-height // span)
    rule = triple_segment_steps(2, height, width, span)
    for chunked in (True, False) if width % 16 == 0 else (False,):
        for steps in sorted({rule, 1, 2, n_blk}):
            got, reads = triple_walk(imgs, span, chunked, steps)
            assert torch.equal(got, want), (chunked, steps)
            per_frame = reads[:len(reads) // 2]
            assert per_frame == [list(range(max(k0 - 1, 0), min(k0 + steps, n_blk - 1) + 1))
                                 for k0 in range(0, n_blk, steps)]


@pytest.mark.parametrize("width", WIDTHS)
def test_triple_at_span_past_height_is_load(rng, width):
    """With span >= H there is one block, prev = cur = next, and TRIPLE is
    LOAD."""
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 29, width), np.uint8))
    for span in (29, 30, 1000):
        assert torch.equal(exp_off.floor_triple(imgs, span), exp_off.floor_load(imgs))


def prefilter_numpy(img: np.ndarray, t: int, count: int) -> np.ndarray:
    """fast_pallas.py:385-396 restated per pixel in numpy int32, one 16-bit
    field at a time: bit 9 of p + hb (bright) and cw - p (dark) per
    cardinal tap, summed, and the biased bit-11 test for >= need; on the
    interior, 0 elsewhere."""
    h, w = img.shape
    x = img.astype(np.int32)
    hb = (511 - t) - x  # fast_pallas.py:378, one field
    cw = x + (511 - t)  # :379
    need = 3 if count >= 12 else 2
    pad = np.pad(x, RADIUS)
    nb = np.zeros_like(x)
    nd = np.zeros_like(x)
    for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0)):  # NORTH, EAST, SOUTH, WEST
        p = pad[RADIUS + dy:RADIUS + dy + h, RADIUS + dx:RADIUS + dx + w]
        nb += (p + hb) & 0x200
        nd += (cw - p) & 0x200
    ta = (4 - need) * 512
    keep = (((nb + ta) | (nd + ta)) & 0x800) != 0
    interior = np.zeros_like(keep)
    interior[RADIUS:h - RADIUS, RADIUS:w - RADIUS] = True
    return keep & interior


@pytest.mark.parametrize("t", [0, 16, 60])
@pytest.mark.parametrize("count", [9, 12, 16])
def test_prefilter_matches_swar_restatement(rng, count, t):
    """PREFILTER == the SWAR cardinal prefilter restated in numpy, exactly,
    on every pixel (the interior rule included)."""
    imgs = rng.integers(0, 256, (2, 61, 157), np.uint8)
    imgs[:, 20:40, 30:90] //= 4  # a dark block: both polarities fire at its edges
    bits = unpack(exp_off.floor_prefilter(torch.from_numpy(imgs), t, count))
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(bits[i, :, :157], prefilter_numpy(img, t, count))
    assert bits.any()


def jax_tile_flags(img: np.ndarray, t: int, count: int) -> np.ndarray:
    """Per 128-row tile, ``tile_has_candidates`` of
    fast_pallas._swar_window_prefilter, in interpret mode, with the
    production halo triple (x, x, x)."""
    x = padded(img, fp.TILE_H)
    hp, wp = x.shape
    n_tiles = hp // fp.TILE_H
    clamp = lambda v: jnp.clip(v, 0, n_tiles - 1)

    def kflag(p_ref, c_ref, n_ref, out_ref):
        *_, has = fp._swar_window_prefilter(p_ref, c_ref, n_ref, threshold=t, count=count,
                                            tile_h=fp.TILE_H)
        out_ref[:, :] = jnp.broadcast_to(has.astype(jnp.int32), (8, 128))

    flags = pl.pallas_call(
        kflag, grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((fp.TILE_H, wp), lambda i: (clamp(i - 1), 0)),
            pl.BlockSpec((fp.TILE_H, wp), lambda i: (i, 0)),
            pl.BlockSpec((fp.TILE_H, wp), lambda i: (clamp(i + 1), 0)),
        ],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n_tiles * 8, 128), jnp.int32),
        interpret=True,
    )(x, x, x)
    return np.asarray(flags)[::8, 0].astype(bool)


@pytest.mark.parametrize("count", [9, 12])
def test_prefilter_empty_tiles_agree(rng, count):
    """No 128-row tile that the JAX prefilter flags as empty has an interior
    keep bit.  One direction only: the JAX plane also covers border rows
    and lanes that wrap around the padded width, which the interior rule
    masks, so a tile the JAX test keeps may have no keep bit here."""
    img = rng.integers(0, 256, (384, 256), np.uint8)
    img[112:272] = 77  # tile 1 (rows 128..255) and every row its taps reach: flat
    flags = jax_tile_flags(img, 16, count)
    assert flags.tolist() == [True, False, True]
    bits = unpack(exp_off.floor_prefilter(torch.from_numpy(img)[None], 16, count))[0]
    for i, has in enumerate(flags):
        if not has:
            assert not bits[i * fp.TILE_H:(i + 1) * fp.TILE_H].any()
    assert bits.any()


def jax_prepack(image: np.ndarray) -> np.ndarray:
    """tools/exp_off_prepack.py ``prepack`` (:51-71), over JAX."""
    h, w = image.shape
    hp, wp = fp.padded_height(h), fp.padded_width(w)
    imgp = jnp.pad(jnp.asarray(image), ((0, hp - h), (0, wp - w)))
    n_tiles = hp // fp.TILE_H
    half = fp.TILE_H // 2
    n = half + 2 * RADIUS + 2
    ti = np.arange(n_tiles)[:, None]
    jj = np.arange(n)[None, :]
    base = ti * fp.TILE_H + jj - RADIUS
    lo_idx = np.clip(base, 0, hp - 1).reshape(-1)
    hi_idx = np.clip(base + half, 0, hp - 1).reshape(-1)
    lo = jnp.take(imgp, jnp.asarray(lo_idx), axis=0).astype(jnp.int32)
    hi = jnp.take(imgp, jnp.asarray(hi_idx), axis=0).astype(jnp.int32)
    return np.asarray(lo | (hi << 16))


@pytest.mark.parametrize("shape", [(2, 300, 150), (1, 128, 128), (1, 7, 9)])
def test_prepack_matches_tool(rng, shape):
    """The plain prepack == the tool's prepack, array-equal, frame by frame:
    (n_tiles * 72, wp) int32."""
    imgs = rng.integers(0, 256, shape, np.uint8)
    plane = exp_off.prepack(torch.from_numpy(imgs))
    assert plane.dtype == torch.int32 and plane.shape[1] % exp_off.PACKED_ROWS == 0
    for i, img in enumerate(imgs):
        assert np.array_equal(plane[i].numpy(), jax_prepack(img))


@pytest.mark.parametrize("count", [9, 12, 16])
def test_words_prepacked_matches_production(rng, count):
    """Words from the prepacked plane == fast_pallas.detect_words_padded OFF
    (interpret mode), cropped to H rows and ceil(W/32) words, on frames
    that span two 128-row tiles; exact.  Also through the wrapper on a CPU
    tensor, which leaves the launch counters alone."""
    img = rng.integers(0, 256, (150, 200), np.uint8)
    img[40:100, 60:140] //= 3
    t = 16 if count < 16 else 8
    want = np.asarray(fp.detect_words_padded(img, t, count, JaxNonmaxMode.OFF, True))[:150, :7]
    plane = exp_off.prepack(torch.from_numpy(img)[None])
    words = exp_off.words_prepacked(plane, t, count, height=150, width=200)
    assert words.shape == (1, 150, 7) and words.dtype == torch.int32
    np.testing.assert_array_equal(words[0].numpy(), want)
    assert words.any()
    before = dict(exp_off_cuda.LAUNCHES)
    assert torch.equal(exp_off_cuda.words_prepacked(plane, t, count, height=150, width=200),
                       words)
    assert exp_off_cuda.LAUNCHES == before


def test_words_prepacked_matches_words_kernel_plain(rng):
    """On a batch with a partial last tile and a width off the 128 grid, the
    prepacked words == the words entry point's CPU path, every count."""
    imgs = rng.integers(0, 256, (2, 141, 99), np.uint8)
    plane = exp_off.prepack(torch.from_numpy(imgs))
    for count in range(9, 17):
        want = fast_cuda.detect_words(torch.from_numpy(imgs), 16, count, NonmaxMode.OFF)
        got = exp_off.words_prepacked(plane, 16, count, height=141, width=99)
        assert torch.equal(got, want), count


def test_words_prepacked_narrow_plane(rng):
    """A plane cut to the frame's own 131 columns (a pitch that is not a
    multiple of 4, which the kernel stages element by element) gives the
    words of the whole plane, equal to the words entry point's CPU path, on
    a 130 x 131 frame whose last tile has its high field past the frame."""
    imgs = torch.from_numpy(rng.integers(0, 256, (1, 130, 131), np.uint8))
    narrow = exp_off.prepack(imgs)[..., :131].contiguous()
    assert narrow.shape == (1, 2 * exp_off.PACKED_ROWS, 131)
    for count in (9, 12, 16):
        want = fast_cuda.detect_words(imgs, 16, count, NonmaxMode.OFF)
        assert torch.equal(exp_off.words_prepacked(narrow, 16, count, height=130, width=131),
                           want)
        assert torch.equal(exp_off_cuda.words_prepacked(narrow, 16, count, height=130,
                                                        width=131), want)


def read_source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def device_function(source: str, name: str) -> str:
    """The device function ``name`` of a CUDA source, its template line to
    its closing brace, with whitespace collapsed (comments inside the body
    included)."""
    m = re.search(r"(template <[^>]*>\s*)?__device__ __forceinline__ \w+ %s\(" % name, source)
    assert m is not None, f"no device function {name}"
    depth = 0
    for i in range(source.index("{", m.end()), len(source)):
        depth += {"{": 1, "}": -1}.get(source[i], 0)
        if depth == 0:
            return " ".join(source[m.start():i + 1].split())
    raise AssertionError(f"unbalanced braces in {name}")


@pytest.mark.parametrize("name", ["stage", "push", "at_least", "runs", "load_taps"])
def test_strip_kernels_copy_fast_cu(name):
    """The OFF-floor strip kernels (PREFILTER and the prepacked words) share
    fdf_fast_words' staging and tests: each device function exp_off.cu
    copies from fast.cu has fast.cu's text, whitespace aside."""
    assert device_function(read_source("exp_off.cu"), name) == \
        device_function(read_source("fast.cu"), name)


def test_strip_constants_match_fast_cu():
    """The constants the copied functions and the strip launch read (strip
    width and heights, block, halo, staged pitch, the full-card block count)
    are fast.cu's: those of exp_off.cu's strip namespace, else its own."""
    def constants(text: str) -> dict:
        return dict(re.findall(r"constexpr (?:int|long long|unsigned) (\w+) = ([^;]+);", text))

    src = read_source("exp_off.cu")
    strip = src[src.index("namespace strip {"):src.index("}  // namespace strip")]
    ours, fast = {**constants(src), **constants(strip)}, constants(read_source("fast.cu"))
    for name in ("STRIP_W", "STRIP_H", "SHORT_H", "THREADS", "RADIUS", "HALO", "SW", "WPR",
                 "FULL", "MIN_BLOCKS"):
        assert ours[name] == fast[name], name


def test_bind_declares_the_c_interface():
    """``bind`` gives each entry point of exp_off.cu the argument types of
    its C signature (pointers and the stream as void*, int, long long) and
    its result type, on any library object: a baseline build of another
    revision is bound the same way."""
    extern = read_source("exp_off.cu").split('extern "C" {')[1]
    sigs = re.findall(r"\n(int|const char\*) (fdf_\w+)\(([^)]*)\)", extern)
    assert len(sigs) == 7
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for _, name, _ in sigs})
    assert exp_off_cuda.bind(lib) is lib
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong}
    for result, name, params in sigs:
        fn = getattr(lib, name)
        assert fn.argtypes == [kinds[" ".join(p.split()[:-1])] for p in params.split(",")], name
        assert fn.restype == (ctypes.c_int if result == "int" else ctypes.c_char_p), name


# tools/exp_off_byteswar.py, :46-52 and the kernel bodies k16 (:60-82) and
# k8 (:84-99), restated.
def _i32c(v):
    return int(np.int32(np.uint32(v & 0xFFFFFFFF)))


_H = _i32c(0x80808080)
_L7 = _i32c(0x7F7F7F7F)
_FF = 0x00010001
_M9 = _i32c(0x200 * _FF)
_TAPS = 16


def k16(x_ref, hb_ref, cw_ref, o_ref):
    p = x_ref[:, :]
    hb = hb_ref[:, :]
    cw = cw_ref[:, :]
    bright = jnp.zeros_like(p)
    dark = jnp.zeros_like(p)
    for k in range(_TAPS):
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
            b = (q << (-s)) & _i32c((_FF << k) & 0xFFFFFFFF)
            d = (r << (-s)) & _i32c((_FF << k) & 0xFFFFFFFF)
        bright = bright | b
        dark = dark | d
        p = p + 1
    o_ref[:, :] = bright ^ dark


def k8(x_ref, hi_ref, lo_ref, o_ref):
    p = x_ref[:, :]
    hi = hi_ref[:, :]
    lo = lo_ref[:, :]
    planes = [jnp.zeros_like(p), jnp.zeros_like(p)]
    for k in range(_TAPS):
        for which, (x, y) in enumerate(((hi, p), (p, lo))):
            w = ((x & _L7) | _H) - (y & _L7)
            r = ((~x & y) | (~(x ^ y) & ~w)) & _H
            s = 7 - (k % 8)
            bit = (r >> s) & _i32c((0x01010101 << (k % 8))
                                   & 0xFFFFFFFF) if s else r
            planes[k // 8] = planes[k // 8] | bit
        p = p + _i32c(0x01010101)
    o_ref[:, :] = planes[0] ^ planes[1]


def jax_pred(kern, x, a, b, rows):
    """The tool's pallas_call (:107-115) at a grid of 4 programs."""
    grid = x.shape[0] // rows
    return np.asarray(pl.pallas_call(
        kern, grid=(grid,),
        in_specs=[pl.BlockSpec((rows, 128), lambda i: (i, 0))] * 3,
        out_specs=pl.BlockSpec((rows, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("low", [-2**31, 0], ids=["full_range", "tool_range"])
@pytest.mark.parametrize("name", ["pred16", "pred8"])
def test_swar_pred_matches_tool(rng, name, low):
    """pred16 / pred8 == k16 / k8 in interpret mode, exactly, on seeded
    planes over the whole int32 range (where ``p + hb``, ``cw - p`` and the
    byte compare's subtraction overflow and wrap) and over the tool's
    [0, 2^30)."""
    rows = 8
    high = 2**31 if low < 0 else 2**30
    x, a, b = (rng.integers(low, high, (4 * rows, 128), np.int64).astype(np.int32)
               for _ in range(3))
    kern, plain = (k16, exp_off.swar_pred16) if name == "pred16" else (k8, exp_off.swar_pred8)
    got = plain(*(torch.from_numpy(v) for v in (x, a, b)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_pred(kern, x, a, b, rows))
    before = dict(exp_off_cuda.LAUNCHES)
    wrapped = getattr(exp_off_cuda, f"swar_{name}")(*(torch.from_numpy(v) for v in (x, a, b)))
    assert torch.equal(wrapped, got) and exp_off_cuda.LAUNCHES == before


def test_floor_wrapper_on_cpu(rng):
    """The floor entry points on a CPU tensor are the plain versions, each
    stage with its own arguments; the kernel counters do not move."""
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 37, 70), np.uint8))
    before = dict(exp_off_cuda.LAUNCHES)
    assert exp_off_cuda.FLOORS.keys() == exp_off.FLOORS.keys() == {"load", "triple", "prefilter"}
    for stage, args in (("load", ()), ("triple", (16,)), ("prefilter", (20, 12))):
        got = exp_off_cuda.FLOORS[stage](imgs, *args)
        assert got.shape == (2, 37, 3) and got.dtype == torch.int32
        assert torch.equal(got, exp_off.FLOORS[stage](imgs, *args))
    assert exp_off_cuda.LAUNCHES == before


def test_wrappers_validate_arguments():
    """Wrong dtype, rank, span, threshold, count, an argument the stage does
    not read, a plane shape or mismatched planes are refused before any
    launch."""
    img = torch.zeros((1, 16, 40), dtype=torch.uint8)
    with pytest.raises(TypeError):
        exp_off_cuda.floor_load(img.to(torch.int32))
    with pytest.raises(ValueError):
        exp_off_cuda.floor_load(img[0])
    with pytest.raises(TypeError):
        exp_off_cuda.floor_load(img, span=8)
    with pytest.raises(TypeError):
        exp_off_cuda.floor_triple(img, threshold=16)
    with pytest.raises(TypeError):
        exp_off_cuda.floor_prefilter(img, span=8)
    with pytest.raises(ValueError):
        exp_off_cuda.floor_triple(img, span=0)
    with pytest.raises(ValueError):
        exp_off_cuda.floor_prefilter(img, threshold=256)
    with pytest.raises(ValueError):
        exp_off_cuda.floor_prefilter(img, count=8)
    with pytest.raises(ValueError):
        exp_off_cuda.floor_load(img.to("meta"))
    plane = exp_off.prepack(img)
    with pytest.raises(ValueError):
        exp_off_cuda.words_prepacked(plane[:, 1:], 16, 9, height=16, width=40)
    with pytest.raises(ValueError):
        exp_off_cuda.words_prepacked(plane, 16, 9, height=129, width=40)
    with pytest.raises(ValueError):
        exp_off_cuda.words_prepacked(plane, 16, 9, height=16, width=129)
    with pytest.raises(TypeError):
        exp_off_cuda.words_prepacked(plane.to(torch.int64), 16, 9, height=16, width=40)
    x = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        exp_off_cuda.swar_pred16(x, x, x[:4])
    with pytest.raises(TypeError):
        exp_off_cuda.swar_pred8(x, x, x.to(torch.int64))
