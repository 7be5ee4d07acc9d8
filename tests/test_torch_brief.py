"""The port's BRIEF module and dense-words wrapper on the CPU, against the
JAX package.

Same seeded numpy inputs through ``feature_detector_fast_tpu.models.brief``
and ``feature_detector_fast_tpu_torch.models.brief``.  Every output is an
integer, so the tolerance is zero, with one stated exception: an
orientation bin may differ where float32 ``atan2`` lands within an ulp of a
bin edge.  Bins must agree at every slot except where the float64 value of
``angle / 2pi * 30`` lies within 1e-4 of a half-integer, and descriptors
must agree wherever the bins do.  The JAX dense kernel runs in interpret
mode, as tests/test_brief_pallas.py runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from feature_detector_fast_tpu.models import brief as jax_brief
from feature_detector_fast_tpu.ops import brief_pallas
from feature_detector_fast_tpu_torch.models import brief
from feature_detector_fast_tpu_torch.ops import brief_cuda

SHAPES = [(64, 128), (97, 130), (200, 300)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs under pytest-xdist with a worker per core; torch's own
    intra-op thread pool would oversubscribe the cores and slow every
    worker, so these tests run torch single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(kps) -> brief.Keypoints:
    """JAX (or numpy) Keypoints -> the port's, on the CPU."""
    return brief.Keypoints(*(torch.from_numpy(np.array(f)) for f in kps))


def u32(desc) -> np.ndarray:
    """Descriptor words of either package as np.uint32."""
    d = desc.numpy() if isinstance(desc, torch.Tensor) else np.asarray(desc)
    return np.ascontiguousarray(d).view(np.uint32)


def near_half_bins(image: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """(K,) bool: the float64 value angle / 2pi * N_ANGLE_BINS of the
    keypoint's intensity-centroid moments (zero-padded 31 x 31 patch) lies
    within 1e-4 of a half-integer, where float32 bins may round apart."""
    r = brief.PATCH_R
    pad = np.pad(image.astype(np.int64), r)
    d = np.arange(-r, r + 1)
    out = np.zeros(len(xy), bool)
    for i, (x, y) in enumerate(np.asarray(xy)):
        if not (0 <= x < image.shape[1] and 0 <= y < image.shape[0]):
            continue
        patch = pad[y: y + 2 * r + 1, x: x + 2 * r + 1]
        m10, m01 = (patch * d[None, :]).sum(), (patch * d[:, None]).sum()
        v = np.arctan2(m01, m10) / (2 * np.pi) * brief.N_ANGLE_BINS
        out[i] = abs(v - np.floor(v) - 0.5) < 1e-4
    return out


def assert_bins_agree(got, want, near) -> np.ndarray:
    """Bins equal except at near-half slots; returns where they agree."""
    got, want = np.asarray(got), np.asarray(want)
    agree = got == want
    assert (agree | near).all(), np.nonzero(~agree & ~near)
    print(f"orientation bins: {int(near.sum())} near-half slots, "
          f"{int((~agree).sum())} differ")
    return agree


def test_tables_match_jax():
    """The carried state -- the pattern and the steered tables -- equals the
    JAX package's arrays."""
    for name in ("PATTERN", "QUADRANT", "RESIDUAL_BIN", "_RESIDUAL_ANGLES",
                 "RESIDUAL_PATTERNS", "ROTATED_PATTERNS"):
        assert np.array_equal(getattr(brief, name), getattr(jax_brief, name)), name
        assert getattr(brief, name).dtype == getattr(jax_brief, name).dtype, name
    for name in ("BITS", "WORDS", "PATCH_R", "BORDER", "N_ANGLE_BINS", "N_RESIDUAL_BINS"):
        assert getattr(brief, name) == getattr(jax_brief, name), name


@pytest.mark.parametrize("shape", [(5, 5), (7, 9), (64, 128), (97, 130)])
def test_box_blur5_matches_jax(rng, shape):
    """Bit-exact with JAX, equal to the clamped-centre closed form, and the
    batch form equals the per-frame one."""
    frames = rng.integers(0, 256, (2, *shape), np.uint8)
    got = brief.box_blur5(torch.from_numpy(frames)).numpy()
    h, w = shape
    for f, g in zip(frames, got):
        np.testing.assert_array_equal(g, np.asarray(jax_brief.box_blur5(f)))
        pad = np.pad(f.astype(np.int64), 2)
        s5 = sum(pad[dy: dy + h, dx: dx + w] for dy in range(5) for dx in range(5))
        cy = np.clip(np.arange(h), 2, h - 3)
        cx = np.clip(np.arange(w), 2, w - 3)
        np.testing.assert_array_equal(g, s5[np.ix_(cy, cx)])
    with pytest.raises(ValueError):
        brief.box_blur5(torch.zeros((4, 9), dtype=torch.uint8))


@pytest.mark.parametrize("r,hi", [(2, 256), (15, 255 * 300), (15, 1 << 24)])
def test_boxsum_chain_matches_jax(rng, r, hi):
    """Zero-padded box sums equal JAX's int32 chain, also where the sums
    wrap past 2**31 (1 << 24 over 961 cells)."""
    x = rng.integers(0, hi, (2, 61, 83)).astype(np.int32)
    got = brief._boxsum_chain(torch.from_numpy(x), r).numpy()
    for f, g in zip(x, got):
        np.testing.assert_array_equal(g, np.asarray(jax_brief._boxsum_chain(f, r)))


@pytest.mark.parametrize("shape", SHAPES)
def test_orientation_bins_match_jax(rng, shape):
    img = rng.integers(0, 256, shape, np.uint8)
    kps = conftest.fuzz_keypoints(rng, *shape, 64)
    got = brief.orientation_bins(torch.from_numpy(img), to_port(kps))
    assert got.dtype == torch.int32 and got.shape == (64,)
    assert_bins_agree(got.numpy(), jax_brief.orientation_bins(img, kps),
                      near_half_bins(img, kps.xy))


def test_orientation_bins_gradient():
    """A left-to-right ramp gives bin 0; top-to-bottom gives pi/2, bin 7.5,
    which rounds half to even: 8."""
    ramp_x = np.tile(np.arange(64, dtype=np.uint8) * 4, (64, 1))
    kp = brief.Keypoints(torch.tensor([[32, 32]], dtype=torch.int32),
                         torch.ones(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool))
    assert int(brief.orientation_bins(torch.from_numpy(ramp_x), kp)[0]) == 0
    assert int(brief.orientation_bins(torch.from_numpy(ramp_x.T.copy()), kp)[0]) == 8


def assert_topk_equal(got: brief.Keypoints, want) -> None:
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_select_topk_matches_jax(rng):
    """The flat torch.topk equals JAX's two-level select_topk and its flat
    oracle, across densities, shapes and k (the fuzz of
    tests/test_frontend.py), frame by frame and as a batch."""
    for _ in range(12):
        h, w = int(rng.integers(8, 90)), int(rng.integers(8, 130))
        mask = rng.random((2, h, w)) < float(rng.choice([0.0, 0.002, 0.05, 0.5]))
        score = rng.integers(0, 4000, (2, h, w)).astype(np.int32)
        for k in (1, 7, 64, 1000):
            batch = brief.select_topk(torch.from_numpy(mask), torch.from_numpy(score), k)
            assert batch.xy.shape == (2, k, 2) and batch.xy.dtype == torch.int32
            for i in range(2):
                want = jax_brief.select_topk(mask[i], score[i], k)
                assert_topk_equal(brief.Keypoints(*(f[i] for f in batch)), want)
                assert_topk_equal(brief.Keypoints(*(f[i] for f in batch)),
                                  jax_brief._select_topk_flat(mask[i], score[i], k))
    h, w = 300, 400
    mask = rng.random((h, w)) < 0.01
    score = rng.integers(0, 4000, (h, w)).astype(np.int32)
    for k in (1000, 2048):
        got = brief.select_topk(torch.from_numpy(mask), torch.from_numpy(score), k)
        assert_topk_equal(got, jax_brief.select_topk(mask, score, k))


def test_select_topk_padding_and_limits():
    """Slots past the keypoints -- the -1 keys, in any order -- decode to
    (0, 0), score 0, invalid, also when k exceeds H*W; u16 planes (the
    detector's) work; frames above 2**29 px are refused."""
    mask = np.zeros((32, 32), np.uint16)
    mask[10, 10] = 1
    score = (mask * 7).astype(np.uint16)
    for k in (8, 32 * 32 + 5):
        kps = brief.select_topk(torch.from_numpy(mask), torch.from_numpy(score), k)
        assert kps.valid.numpy().tolist() == [True] + [False] * (k - 1)
        assert kps.xy[0].tolist() == [10, 10] and int(kps.score[0]) == 7
        assert (kps.xy[1:] == 0).all() and (kps.score[1:] == 0).all()
        assert_topk_equal(kps, jax_brief.select_topk(mask.astype(bool), score, k))
    huge = torch.zeros((1, 1), dtype=torch.bool).expand(1 << 15, 1 << 15)
    with pytest.raises(ValueError, match="too large"):
        brief.select_topk(huge, huge, 4)


@pytest.mark.parametrize("oriented", [False, True], ids=["plain", "oriented"])
@pytest.mark.parametrize("shape", SHAPES)
def test_describe_matches_jax(rng, shape, oriented):
    """The sparse gathers (the CPU path) equal JAX's at every slot, valid or
    not (the same computation), bins aside; the batch equals the frames."""
    frames = rng.integers(0, 256, (2, *shape), np.uint8)
    kps = [conftest.fuzz_keypoints(rng, *shape, 64) for _ in range(2)]
    both = brief.Keypoints(*(torch.stack([to_port(k)[i] for k in kps]) for i in range(3)))
    fn = brief.describe_oriented if oriented else brief.describe
    desc, valid = fn(torch.from_numpy(frames), both)
    assert desc.shape == (2, 64, brief.WORDS) and desc.dtype == torch.int32
    for i in range(2):
        j_fn = jax_brief.describe_oriented if oriented else jax_brief.describe
        j_desc, j_valid = j_fn(frames[i], kps[i])
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(j_valid))
        agree = np.ones(64, bool)
        if oriented:
            agree = assert_bins_agree(
                brief.orientation_bins(torch.from_numpy(frames[i]), to_port(kps[i])).numpy(),
                jax_brief.orientation_bins(frames[i], kps[i]), near_half_bins(frames[i], kps[i].xy))
        np.testing.assert_array_equal(u32(desc[i])[agree], u32(j_desc)[agree])
        one, one_valid = fn(torch.from_numpy(frames[i]), to_port(kps[i]))
        np.testing.assert_array_equal(one.numpy(), desc[i].numpy())
        np.testing.assert_array_equal(one_valid.numpy(), valid[i].numpy())


def test_describe_invariant_to_shift(rng):
    """Same patch content elsewhere -> identical descriptor."""
    patch = rng.integers(0, 256, (41, 41), np.uint8)
    img1 = np.full((96, 96), 127, np.uint8)
    img2 = np.full((96, 96), 127, np.uint8)
    img1[20:61, 20:61] = patch
    img2[30:71, 25:66] = patch
    ones = (torch.ones(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool))
    d1, v1 = brief.describe(torch.from_numpy(img1), brief.Keypoints(torch.tensor([[40, 40]]), *ones))
    d2, v2 = brief.describe(torch.from_numpy(img2), brief.Keypoints(torch.tensor([[45, 50]]), *ones))
    assert bool(v1[0]) and bool(v2[0])
    assert torch.equal(d1, d2)


@pytest.mark.parametrize("shape", [(64, 128), (97, 130)])
def test_describe_words_plain_matches_jax_band(rng, shape):
    """The plain dense words equal JAX's describe_words_padded (interpret
    mode) wherever JAX defines its planes: at least BORDER from every
    edge."""
    h, w = shape
    img = rng.integers(0, 256, shape, np.uint8)
    planes = brief_cuda.describe_words(torch.from_numpy(img)[None])
    assert planes.shape == (1, brief.WORDS, h, w) and planes.dtype == torch.int32
    b = brief.BORDER
    for j, jp in enumerate(brief_pallas.describe_words_padded(img, True)):
        np.testing.assert_array_equal(u32(planes[0, j])[b:h - b, b:w - b],
                                      u32(jp)[:h, :w][b:h - b, b:w - b])


def test_describe_words_plain_defined_everywhere(rng):
    """On every pixel, border included, bit b of word j is
    blur(clamp(p + o1)) < blur(clamp(p + o2)): a numpy restatement."""
    frames = rng.integers(0, 256, (2, 23, 41), np.uint8)
    planes = u32(brief_cuda.describe_words_plain(torch.from_numpy(frames)))
    p = jax_brief.PATTERN
    x1, y1, x2, y2 = p[:, 0, 0], p[:, 0, 1], p[:, 1, 0], p[:, 1, 1]
    for i, f in enumerate(frames):
        blur = np.asarray(jax_brief.box_blur5(f))
        h, w = f.shape
        for y in range(h):
            for x in range(w):
                a = blur[np.clip(y + y1, 0, h - 1), np.clip(x + x1, 0, w - 1)]
                c = blur[np.clip(y + y2, 0, h - 1), np.clip(x + x2, 0, w - 1)]
                want = np.packbits((a < c).reshape(brief.WORDS, 32)[:, ::-1],
                                   axis=1).view(">u4")[:, 0]
                np.testing.assert_array_equal(planes[i, :, y, x], want)


@pytest.mark.parametrize("shape", SHAPES)
def test_describe_dense_matches_jax(rng, shape):
    """describe_dense (the plain words on the CPU) equals JAX's sparse and
    dense (interpret) routes at valid slots; gather_descriptors equals
    JAX's on the same planes."""
    img = rng.integers(0, 256, shape, np.uint8)
    kps = conftest.fuzz_keypoints(rng, *shape, 64)
    desc, valid = brief.describe_dense(torch.from_numpy(img), to_port(kps))
    j_desc, j_valid = jax_brief.describe(img, kps)
    v = np.array(j_valid)
    assert v.any()
    np.testing.assert_array_equal(valid.numpy(), v)
    np.testing.assert_array_equal(u32(desc)[v], u32(j_desc)[v])
    planes = brief_cuda.describe_words(torch.from_numpy(img)[None])
    got = brief_cuda.gather_descriptors(planes, to_port(kps).xy[None], torch.from_numpy(v)[None])
    want = brief_pallas.gather_descriptors(tuple(jnp.asarray(p) for p in planes[0].numpy()),
                                           kps.xy, v)
    np.testing.assert_array_equal(u32(got[0]), u32(want))


def test_dense_route_threshold_scales_with_pixels():
    """The describe route switches at a keypoint density: 4500 keypoints
    on a 1080p frame, 4x that at 4K, the same share of a VGA frame or of
    the 200 x 300 reference frame."""
    assert [brief._dense_k_min(h, w) for h, w in
            ((1080, 1920), (2160, 3840), (480, 640), (200, 300))] == [4500, 18000, 666, 130]


def test_describe_words_wrapper_checks():
    """A CPU tensor takes the plain version and never counts a launch; bad
    arguments are refused."""
    before = dict(brief_cuda.LAUNCHES)
    frames = torch.zeros((1, 40, 40), dtype=torch.uint8)
    assert torch.equal(brief_cuda.describe_words(frames), brief_cuda.describe_words_plain(frames))
    assert brief_cuda.LAUNCHES == before
    with pytest.raises(TypeError):
        brief_cuda.describe_words(frames.to(torch.int32))
    with pytest.raises(ValueError):
        brief_cuda.describe_words(frames[0])
    with pytest.raises(ValueError):
        brief_cuda.describe_words(torch.zeros((1, 4, 40), dtype=torch.uint8))


def emulate_brief_kernel(frames: torch.Tensor) -> torch.Tensor:
    """``csrc/brief.cu``'s arithmetic in torch, block by block: each block's
    blurred region as two copies of u16 cells paired two to a 32-bit word,
    read at ``brief_cuda.pair_table()``'s word offsets from each lane's own
    word; both pixels of a word compared by one add (bits 15 and 31 of
    ``b - a + 0x7FFF7FFF``), the bits gathered into two accumulators and
    split by the kernel's byte permutes.  (B, WORDS, H, W) int32."""
    bc = brief_cuda
    n, h, w = frames.shape
    r = brief.PATCH_R
    blur = brief.box_blur5(frames).to(torch.int64)
    table = torch.from_numpy(bc.pair_table().astype(np.int64))  # (BITS, 2)
    rows_b, cols_b = bc.TILE_H + 2 * r, bc.TILE_W + 2 * r
    lane = torch.arange(32)
    lr = torch.arange(bc.TILE_H)
    base = (lr[:, None] * bc.ROW_WORDS + lane[None, :]).reshape(-1)  # (64 rows x 32 lanes)
    out = torch.zeros((n, brief.WORDS, h, w), dtype=torch.int64)
    for y0 in range(0, h, bc.TILE_H):
        for x0 in range(0, w, bc.TILE_W):
            ys = torch.arange(y0 - r, y0 - r + rows_b).clamp(0, h - 1)
            xs = torch.arange(x0 - r, x0 - r + cols_b).clamp(0, w - 1)
            cells = blur[:, ys][:, :, xs]  # (n, 94, 94): the clamp extends the blur
            pad = torch.zeros((n, rows_b, 2 * bc.COPY_WORDS + 2), dtype=torch.int64)
            pad[:, :, :cols_b] = cells
            copy0 = pad[:, :, 0:2 * bc.COPY_WORDS:2] | (pad[:, :, 1:2 * bc.COPY_WORDS:2] << 16)
            copy1 = pad[:, :, 1:2 * bc.COPY_WORDS + 1:2] | (pad[:, :, 2:2 * bc.COPY_WORDS + 2:2] << 16)
            spare = torch.zeros((n, rows_b, bc.ROW_WORDS - 2 * bc.COPY_WORDS), dtype=torch.int64)
            region = torch.cat([copy0, copy1, spare], -1).reshape(n, -1)  # (n, 94 * ROW_WORDS)
            a = region[:, base[:, None] + table[None, :, 0]]  # (n, 2048, BITS)
            b = region[:, base[:, None] + table[None, :, 1]]
            d = (b - a + 0x7FFF7FFF) & 0xFFFFFFFF
            g = torch.arange(brief.BITS) % 16
            bits = (d >> (15 - g)) & (0x00010001 << g)
            acc = bits.reshape(n, -1, brief.WORDS, 2, 16).sum(-1)  # disjoint bits: sum = OR
            lo, hi = acc[..., 0], acc[..., 1]
            w0 = (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)  # __byte_perm(lo, hi, 0x5410)
            w1 = (lo >> 16) | (hi & 0xFFFF0000)         # __byte_perm(lo, hi, 0x7632)
            words = torch.stack([w0, w1], -1).reshape(n, bc.TILE_H, 32, brief.WORDS, 2)
            words = words.permute(0, 3, 1, 2, 4).reshape(n, brief.WORDS, bc.TILE_H, bc.TILE_W)
            hh, ww = min(bc.TILE_H, h - y0), min(bc.TILE_W, w - x0)
            out[:, :, y0:y0 + hh, x0:x0 + ww] = words[:, :, :hh, :ww]
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


@pytest.mark.parametrize("shape", [(2, 5, 7), (1, 70, 131), (2, 23, 41)])
def test_pair_table_emulation_matches_plain(rng, shape):
    """The kernel's lookup of the pair table and its packed compares,
    emulated in torch, give describe_words_plain on every pixel: frames
    smaller than a block, and one past two blocks wide and a block tall."""
    frames = torch.from_numpy(rng.integers(0, 256, shape, np.uint8))
    assert torch.equal(emulate_brief_kernel(frames), brief_cuda.describe_words_plain(frames))


def test_pair_table_layout():
    """Every endpoint lies in the blurred region a lane can reach, in the
    copy whose word pairs its two cells: offsets in [0, most], copy 1
    exactly for odd dx + 15."""
    t = brief_cuda.pair_table()
    assert t.shape == (brief.BITS, 2) and t.dtype == np.int32
    most = 2 * brief.PATCH_R * brief_cuda.ROW_WORDS + brief_cuda.COPY_WORDS + brief.PATCH_R
    assert t.min() >= 0 and t.max() <= most
    col = t % brief_cuda.ROW_WORDS
    dx = brief.PATTERN[..., 0] + brief.PATCH_R
    np.testing.assert_array_equal(col >= brief_cuda.COPY_WORDS, dx % 2 == 1)
    np.testing.assert_array_equal(col % brief_cuda.COPY_WORDS, dx // 2)
    np.testing.assert_array_equal(t // brief_cuda.ROW_WORDS, brief.PATTERN[..., 1] + brief.PATCH_R)


def test_pair_macros_compiled_into_kernel():
    """csrc/brief.cu compiles in the pair table: its tiling constants are
    the ones pair_table() is built for, its BEGIN PAIRS block is
    pair_macros() as generated from PATTERN, and each plane's macro lists
    its 32 pairs once, with pair_table()'s offsets."""
    import os
    import re

    path = os.path.join(os.path.dirname(brief_cuda.__file__), os.pardir, "csrc", "brief.cu")
    src = open(path).read()
    consts = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        consts[name] = eval(expr, {"__builtins__": {}}, dict(consts))
    assert {name: consts[name] for name in ("TILE_W", "TILE_H", "ROWS", "COPY_WORDS",
                                            "ROW_WORDS", "REACH")} == {
        "TILE_W": brief_cuda.TILE_W, "TILE_H": brief_cuda.TILE_H, "ROWS": brief_cuda.ROWS,
        "COPY_WORDS": brief_cuda.COPY_WORDS, "ROW_WORDS": brief_cuda.ROW_WORDS,
        "REACH": brief.PATCH_R}
    block = src[src.index("// BEGIN PAIRS\n") + len("// BEGIN PAIRS\n"):src.index("// END PAIRS")]
    assert block == brief_cuda.pair_macros()
    table = brief_cuda.pair_table()
    for j, body in enumerate(re.split(r"#define FDF_PAIRS_\d\(X\)", block)[1:]):
        got = sorted((int(b), int(o1), int(o2))
                     for b, o1, o2 in re.findall(r"X\((\d+), (\d+), (\d+)\)", body))
        assert got == [(b, *table[32 * j + b]) for b in range(32)]


def test_distinct_cells_a_lane_loads():
    """The shared loads brief.cu's compiled-in table needs: a lane reads,
    for each plane, each distinct word (an endpoint's offset + r rows) of
    its ROWS rows once -- 1709 of the 2048 endpoint samples of 4 rows, 214
    a pixel (it computes 2 x 4), against 256 with a run-time table."""
    table = brief_cuda.pair_table().astype(np.int64)
    rows = np.arange(brief_cuda.ROWS) * brief_cuda.ROW_WORDS
    loads = sum(len(np.unique(table[32 * j:32 * j + 32].reshape(-1)[:, None] + rows))
                for j in range(brief.WORDS))
    assert brief_cuda.ROWS == 4 and loads == 1709
    assert loads / (2 * brief_cuda.ROWS) == pytest.approx(213.6, abs=0.05)
