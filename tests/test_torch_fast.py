"""The port's plain PyTorch detector and its kernel wrappers, on the CPU,
against the JAX package.

Same inputs (seeded numpy frames) through ``feature_detector_fast_tpu.ops``
and ``feature_detector_fast_tpu_torch.ops``.  Every output is an integer
(masks, scores, packed words), so every comparison is exact: the tolerance
is zero.  The JAX Pallas words kernel runs in interpret mode, as
tests/test_pallas.py runs it.
"""

import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.config import NonmaxMode as JaxNonmaxMode
from feature_detector_fast_tpu.ops import compact as jax_compact
from feature_detector_fast_tpu.ops import fast as jax_fast
from feature_detector_fast_tpu.ops import fast_pallas
from feature_detector_fast_tpu_torch.config import NonmaxMode
from feature_detector_fast_tpu_torch.ops import compact, fast, fast_cuda

MODES = list(NonmaxMode)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs under pytest-xdist with a worker per core; torch's own
    intra-op thread pool would oversubscribe the cores and slow every
    worker, so these tests run torch single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_dense(frame: np.ndarray, t: int, n: int, mode: NonmaxMode):
    mask, score = jax_fast.detect_dense(frame, t, n, JaxNonmaxMode(mode.value))
    return np.asarray(mask), np.asarray(score)


def assert_dense_matches_jax(frames: np.ndarray, t: int, n: int, mode: NonmaxMode):
    """Plain torch on the whole (B, H, W) batch == JAX frame by frame."""
    mask, score = fast.detect_dense(torch.from_numpy(frames), t, n, mode)
    assert mask.dtype == torch.bool and score.dtype == torch.uint16
    for i, frame in enumerate(frames):
        j_mask, j_score = jax_dense(frame, t, n, mode)
        np.testing.assert_array_equal(mask[i].numpy(), j_mask)
        np.testing.assert_array_equal(score[i].numpy(), j_score)
    return mask


@pytest.mark.parametrize("count", range(9, 17))
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
def test_dense_matches_jax(rng, mode, count):
    """All 3 modes x counts 9..=16 on a seeded (2, 37, 83) batch; exact."""
    frames = rng.integers(0, 256, (2, 37, 83), np.uint8)
    frames[:, 10:20, 20:40] //= 3  # a dark block: corners for every count
    t = 16 if count % 2 else 40
    mask = assert_dense_matches_jax(frames, t, count, mode)
    if count <= 12:
        assert mask.any()


@pytest.mark.parametrize("pattern", ["white", "black", "checker", "gradient"])
def test_dense_pathological_images(pattern):
    """The four degenerate inputs of tests/test_pallas.py, all modes; exact.
    Uniform fields have no keypoints."""
    h, w = 64, 128
    if pattern == "white":
        img = np.full((h, w), 255, np.uint8)
    elif pattern == "black":
        img = np.zeros((h, w), np.uint8)
    elif pattern == "checker":
        yy, xx = np.mgrid[:h, :w]
        img = (((yy // 4 + xx // 4) % 2) * 255).astype(np.uint8)
    else:
        img = np.tile(np.arange(w, dtype=np.uint8)[None, :] * 2, (h, 1))
    for mode in MODES:
        mask = assert_dense_matches_jax(img[None], 16, 9, mode)
        if pattern in ("white", "black"):
            assert not mask.any()


@pytest.mark.parametrize(
    "shape", [(1, 1), (6, 40), (7, 7), (13, 9), (61, 157)])
def test_dense_odd_and_tiny_shapes(rng, shape):
    """Odd and tiny frames run without error and match JAX exactly; a frame
    under 7 px in either dimension has no detectable pixel at all."""
    img = rng.integers(0, 256, shape, np.uint8)
    for mode in MODES:
        mask = assert_dense_matches_jax(img[None], 10, 9, mode)
        if min(shape) < 7:
            assert not mask.any()


@pytest.mark.parametrize("cfg", [
    (16, 9, NonmaxMode.OFF),
    (16, 9, NonmaxMode.MAX_THRESHOLD),
    (16, 9, NonmaxMode.SUM_ABSOLUTE),
    (10, 12, NonmaxMode.MAX_THRESHOLD),
], ids=str)
def test_words_match_pallas_interpret(rng, cfg):
    """The words entry point on the CPU == the JAX Pallas words kernel
    (interpret mode), cropped to H rows and ceil(W/32) words; exact."""
    t, n, mode = cfg
    img = rng.integers(0, 256, (45, 150), np.uint8)
    jax_words = np.asarray(fast_pallas.detect_words_padded(
        img, t, n, JaxNonmaxMode(mode.value), True))
    words = fast_cuda.detect_words(torch.from_numpy(img)[None], t, n, mode)
    assert words.shape == (1, 45, 5) and words.dtype == torch.int32
    np.testing.assert_array_equal(words[0].numpy(), jax_words[:45, :5])


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
def test_dense_wrapper_on_cpu(reference_image, mode):
    """The dense entry point on a CPU tensor: u16 mask and u16 score equal
    to JAX on the reference frame; the kernel counters do not move."""
    before = dict(fast_cuda.LAUNCHES)
    mask, score = fast_cuda.detect_dense(torch.from_numpy(reference_image)[None], 16, 9, mode)
    assert mask.dtype == score.dtype == torch.uint16
    j_mask, j_score = jax_dense(reference_image, 16, 9, mode)
    np.testing.assert_array_equal(mask[0].numpy(), j_mask.astype(np.uint16))
    np.testing.assert_array_equal(score[0].numpy(), j_score)
    assert fast_cuda.LAUNCHES == before


def test_wrappers_validate_arguments():
    """Wrong dtype, rank, threshold or count is refused before any launch."""
    img = torch.zeros((1, 16, 16), dtype=torch.uint8)
    for entry in (fast_cuda.detect_words, fast_cuda.detect_dense):
        with pytest.raises(TypeError):
            entry(img.to(torch.int32), 16, 9, NonmaxMode.OFF)
        with pytest.raises(TypeError):
            entry(img.numpy(), 16, 9, NonmaxMode.OFF)
        with pytest.raises(ValueError):
            entry(img[0], 16, 9, NonmaxMode.OFF)
        for bad_t in (-1, 256):
            with pytest.raises(ValueError):
                entry(img, bad_t, 9, NonmaxMode.OFF)
        for bad_n in (8, 17):
            with pytest.raises(ValueError):
                entry(img, 16, bad_n, NonmaxMode.OFF)
        with pytest.raises(ValueError):
            entry(img.to("meta"), 16, 9, NonmaxMode.OFF)


@pytest.mark.parametrize("shape", [(2, 9, 64), (3, 17, 70), (1, 5, 31)])
def test_word_packing_and_decode(rng, shape):
    """pack_mask_words puts column 32*j+b in bit b of word j; on a 32-aligned
    width its flat stream equals the JAX pack_mask_words.  The decode gives
    the exact row-major (b, y, x) list, and the counts per frame."""
    mask = rng.random(shape) < 0.2
    mask[0, 0, -1] = True  # a sign-bit word when W % 32 == 0
    words = compact.pack_mask_words(torch.from_numpy(mask))
    b, h, w = shape
    assert words.shape == (b, h, -(-w // 32)) and words.dtype == torch.int32
    padded = np.zeros((b, h, words.shape[-1] * 32), bool)
    padded[..., :w] = mask
    bits = (words.numpy().view(np.uint32)[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(bits.reshape(b, h, -1).astype(bool), padded)
    if w % 32 == 0:
        j_words, j_n = jax_compact.pack_mask_words(mask[0])
        np.testing.assert_array_equal(words[0].numpy().reshape(-1), np.asarray(j_words))
        assert int(j_n) == int(mask[0].sum())

    points = compact.words_to_points(words)
    np.testing.assert_array_equal(points.numpy(), np.argwhere(mask))
    np.testing.assert_array_equal(compact.count_points(words).numpy(), mask.sum(axis=(1, 2)))
    frames = compact.split_frames(points, b)
    for i, xy in enumerate(frames):
        yx = np.argwhere(mask[i])
        assert xy.dtype == np.uint32
        np.testing.assert_array_equal(xy, yx[:, ::-1])
