"""The port's row-sharded detection on the CPU, against the JAX package.

The port's ``parallel/spatial.py`` runs on a mesh of repeated CPU devices
(``make_mesh(devices=[cpu] * n)``), the counterpart of the JAX package's
spoofed 8-device CPU mesh (tests/conftest.py), on which the JAX
``parallel.spatial`` runs with its Pallas kernels in interpret mode, as
tests/test_spatial.py runs it.  The plain version of the row-shard kernels
is also fed the JAX package's own 64-row-halo slabs.  Every output is an
integer, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_fast_tpu import Config as JaxConfig, api as jax_api
from feature_detector_fast_tpu.config import NonmaxMode as JaxNonmaxMode
from feature_detector_fast_tpu.ops import fast as jax_fast, fast_pallas
from feature_detector_fast_tpu.parallel import mesh as jax_meshlib, spatial as jax_spatial
from feature_detector_fast_tpu_torch.config import NonmaxMode
from feature_detector_fast_tpu_torch.ops import compact, fast, fast_cuda
from feature_detector_fast_tpu_torch.parallel import mesh as meshlib, spatial

MODES = list(NonmaxMode)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker (see tests/test_torch_fast.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n: int) -> meshlib.Mesh:
    return meshlib.make_mesh(devices=[CPU] * n)


def jax_mode(mode: NonmaxMode) -> JaxNonmaxMode:
    return JaxNonmaxMode(mode.value)


def jax_dense(img: np.ndarray, t: int, n: int, mode: NonmaxMode):
    mask, score = jax_fast.detect_dense(jnp.asarray(img), t, n, jax_mode(mode))
    return np.asarray(mask), np.asarray(score)


def jax_list(img: np.ndarray, t: int, n: int, mode: NonmaxMode) -> np.ndarray:
    return np.asarray(jax_api.detect_arrays(img, JaxConfig(t, n, jax_mode(mode))))


def assert_sharded_equals_jax(img: np.ndarray, t: int, n: int, mode: NonmaxMode, shards: int):
    """Mask, score and keypoint list of the row-sharded port == the JAX
    whole-frame detector; returns the mask."""
    mesh = cpu_mesh(shards)
    mask, score = spatial.detect_rows_sharded(img, t, n, mode, mesh=mesh)
    j_mask, j_score = jax_dense(img, t, n, mode)
    assert mask.dtype == torch.bool and score.dtype == torch.uint16
    np.testing.assert_array_equal(mask.numpy(), j_mask)
    np.testing.assert_array_equal(score.numpy(), j_score)
    xy = spatial.detect_arrays_rows_sharded(img, t, n, mode, mesh=mesh)
    assert xy.dtype == np.uint32 and xy.shape[1:] == (2,)
    np.testing.assert_array_equal(xy, jax_list(img, t, n, mode))
    return mask


def jax_slabs(img: np.ndarray, shards: int):
    """The JAX package's shard slabs, as parallel/spatial.py builds them:
    (shards, rows + 128, padded width) with the wrapped 64-row halos, and
    each shard's global first row."""
    h, w = img.shape
    tile = fast_pallas.TILE_H_SHARD
    hp = -(-h // (shards * tile)) * shards * tile
    wp = fast_pallas.padded_width(w)
    padded = np.pad(img, ((0, hp - h), (0, wp - w)))
    rows = hp // shards
    blocks = padded.reshape(shards, rows, wp)
    ext = np.stack([np.concatenate([blocks[s - 1][-tile:], blocks[s],
                                    blocks[(s + 1) % shards][:tile]])
                    for s in range(shards)])
    return ext, np.arange(shards) * rows


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
def test_tiles_plain_matches_pallas_interpret(rng, mode):
    """The tiles entry points on the CPU (the plain version) == the JAX
    row-shard kernels detect_dense_tiles / detect_words_tiles in interpret
    mode, on JAX's own 64-row-halo slabs of a 150 x 90 frame in 3 shards:
    dense planes cropped to the width, the first ceil(90/32) word lanes,
    and JAX's other lanes all 0."""
    img = rng.integers(0, 256, (150, 90), np.uint8)
    img[60:70, 20:50] //= 4  # keypoints on the shard seam at row 64
    h, w = img.shape
    ext, row0 = jax_slabs(img, 3)
    t_ext = torch.from_numpy(ext)
    t_row0 = torch.from_numpy(row0.astype(np.int32))
    kw = dict(height=h, width=w, halo=fast_pallas.TILE_H_SHARD)
    before = dict(fast_cuda.LAUNCHES)
    mask, score = fast_cuda.detect_dense_tiles(t_ext, t_row0, 16, 9, mode, **kw)
    words = fast_cuda.detect_words_tiles(t_ext, t_row0, 16, 9, mode, **kw)
    assert fast_cuda.LAUNCHES == before  # CPU tensors never launch
    assert mask.shape == score.shape == (3, 64, w) and words.shape == (3, 64, 3)
    tile = fast_pallas.TILE_H_SHARD
    for s in range(3):
        j_mask, j_score = fast_pallas.detect_dense_tiles(
            jnp.asarray(ext[s]), row0[s] // tile, 16, 9, jax_mode(mode),
            height=h, width=w, interpret=True)
        np.testing.assert_array_equal(mask[s].numpy(), np.asarray(j_mask)[:, :w])
        np.testing.assert_array_equal(score[s].numpy(), np.asarray(j_score)[:, :w])
        j_words = np.asarray(fast_pallas.detect_words_tiles(
            jnp.asarray(ext[s]), row0[s] // tile, 16, 9, jax_mode(mode),
            height=h, width=w, interpret=True))
        np.testing.assert_array_equal(words[s].numpy(), j_words[:, :3])
        assert not j_words[:, 3:].any()
    seam = mask.reshape(-1, w)[62:67].any(dim=1)
    assert seam.all(), "no keypoint on a row next to the seam"


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
def test_rows_sharded_matches_jax_spatial(reference_image, mode):
    """detect_rows_sharded and detect_arrays_rows_sharded on 8 CPU shards ==
    the JAX spatial functions on the 8-device CPU mesh (Pallas interpret)."""
    mesh = cpu_mesh(8)
    j_mesh = jax_meshlib.make_mesh()
    img = jnp.asarray(reference_image)
    mask, score = spatial.detect_rows_sharded(reference_image, 16, 9, mode, mesh=mesh)
    j_mask, j_score = jax_spatial.detect_rows_sharded(
        img, 16, 9, jax_mode(mode), mesh=j_mesh, interpret=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(score.numpy(), np.asarray(j_score))
    xy = spatial.detect_arrays_rows_sharded(reference_image, 16, 9, mode, mesh=mesh)
    j_xy = jax_spatial.detect_arrays_rows_sharded(
        img, 16, 9, jax_mode(mode), mesh=j_mesh, interpret=True)
    np.testing.assert_array_equal(xy, np.asarray(j_xy))
    assert len(xy) == {"off": 309, "max_threshold": 131, "sum_absolute": 135}[mode.value]


@pytest.mark.parametrize("count", [9, 12, 16])
def test_rows_sharded_random(rng, count):
    """A random 1024 x 260 frame, SA t=12, 8 shards of 128 rows: every seam
    carries keypoints; == JAX ops.fast.detect_dense of the whole frame."""
    img = rng.integers(0, 256, (1024, 260), np.uint8)
    mask = assert_sharded_equals_jax(img, 12, count, NonmaxMode.SUM_ABSOLUTE, 8)
    rows = spatial.shard_rows(1024, 8)
    seams = [r for s in range(1, 8) for r in (s * rows - 1, s * rows)]
    assert mask[seams].any(dim=1).all()


def test_exact_multiple_height_garbage_halo_is_masked(rng):
    """A frame of exactly 8 * 64 rows: no padding row isolates the global
    top and bottom, whose halos hold the other end's wrapped rows; every
    output those rows can reach is masked (the JAX package's
    test_sharded_garbage_halo_is_masked).  Any filler gives the same."""
    img = rng.integers(0, 256, (512, 131), np.uint8)
    assert spatial.shard_rows(512, 8) * 8 == 512
    for mode in MODES:
        assert_sharded_equals_jax(img, 16, 9, mode, 8)
    # The tiles version directly, with random filler in the outer halos.
    ext = torch.from_numpy(np.stack([
        np.concatenate([rng.integers(0, 256, (4, 131), np.uint8), img[:64], img[64:68]]),
        np.concatenate([img[-68:-64], img[-64:], rng.integers(0, 256, (4, 131), np.uint8)]),
    ]))
    row0 = torch.tensor([0, 448], dtype=torch.int32)
    for mode in MODES:
        mask, score = fast_cuda.detect_dense_tiles(ext, row0, 16, 9, mode,
                                                   height=512, width=131, halo=4)
        j_mask, j_score = jax_dense(img, 16, 9, mode)
        np.testing.assert_array_equal(mask.numpy().astype(bool), j_mask[[*range(64), *range(448, 512)]].reshape(2, 64, 131))
        np.testing.assert_array_equal(score.numpy(), j_score[[*range(64), *range(448, 512)]].reshape(2, 64, 131))


def test_dense_frame_drops_no_keypoint(rng):
    """The JAX package's keypoint-list overflow-retry test becomes a dense
    frame: with no cap there is nothing to overflow, and every keypoint of
    the whole-frame list comes back."""
    img = rng.integers(0, 256, (512, 131), np.uint8)
    xy = spatial.detect_arrays_rows_sharded(img, 0, 9, NonmaxMode.OFF, mesh=cpu_mesh(8))
    want = jax_list(img, 0, 9, NonmaxMode.OFF)
    assert len(want) > 0.2 * 506 * 125  # over a fifth of the detectable pixels
    np.testing.assert_array_equal(xy, want)


def test_wide_8192(rng):
    """A 96 x 8192 frame: the words kernel has no width cap."""
    img = rng.integers(0, 256, (96, 8192), np.uint8)
    xy = spatial.detect_arrays_rows_sharded(img, 16, 9, NonmaxMode.OFF, mesh=cpu_mesh(8))
    want = jax_list(img, 16, 9, NonmaxMode.OFF)
    assert len(want) > 100 and xy[:, 0].max() > 8000
    np.testing.assert_array_equal(xy, want)


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_shard_counts(reference_image, shards):
    """1, 3 and 8 shards of the reference frame, every mode, == JAX."""
    for mode in MODES:
        assert_sharded_equals_jax(reference_image, 16, 9, mode, shards)


def test_shards_sharing_devices_in_runs(rng):
    """Consecutive shards on one device form one run: one slab stack (4
    shards of 24 rows of a 70-row frame, each with 4 + 4 halo rows), one
    launch, the same list as the whole frame."""
    img = rng.integers(0, 256, (70, 77), np.uint8)
    slabs = spatial.shard_slabs(torch.from_numpy(img), [CPU] * 4, spatial.shard_rows(70, 4))
    assert len(slabs) == 1
    (dev, first, n), ext, row0 = slabs[0]
    assert (dev, first, n) == (CPU, 0, 4) and ext.shape == (4, 24 + 8, 77)
    assert row0.tolist() == [0, 24, 48, 72]
    np.testing.assert_array_equal(
        spatial.detect_arrays_rows_sharded(img, 10, 9, NonmaxMode.MAX_THRESHOLD, mesh=cpu_mesh(4)),
        jax_list(img, 10, 9, NonmaxMode.MAX_THRESHOLD))


def test_plain_row_offset_rules(rng):
    """ops.fast.detect_dense with row_offset/height: a buffer that is rows
    [r0, r0 + n) of a frame gives the frame's rows where its circle and
    nonmax ring lie inside the buffer, and the border rows of the frame
    stay dropped."""
    img = torch.from_numpy(rng.integers(0, 256, (40, 50), np.uint8))
    for mode in MODES:
        whole_m, whole_s = fast.detect_dense(img, 10, 9, mode)
        for r0 in (0, 5, 17, 24):
            m, s = fast.detect_dense(img[r0:r0 + 16], 10, 9, mode, row_offset=r0, height=40)
            inner = slice(4, 12)  # 4 rows of context on each side
            assert torch.equal(m[inner], whole_m[r0 + 4:r0 + 12])
            assert torch.equal(s[inner], whole_s[r0 + 4:r0 + 12])
        default = fast.detect_dense(img, 10, 9, mode)
        explicit = fast.detect_dense(img, 10, 9, mode, row_offset=0, height=40)
        assert all(torch.equal(a, b) for a, b in zip(default, explicit))


def test_tiles_wrappers_validate_arguments():
    """Bad halos, row0 and frame sizes are refused before any launch."""
    ext = torch.zeros((2, 16, 40), dtype=torch.uint8)
    row0 = torch.tensor([0, 8], dtype=torch.int32)
    kw = dict(height=16, width=40, halo=4)
    for entry in (fast_cuda.detect_dense_tiles, fast_cuda.detect_words_tiles):
        entry(ext, row0, 16, 9, NonmaxMode.OFF, **kw)
        with pytest.raises(ValueError, match="halo"):
            entry(ext, row0, 16, 9, NonmaxMode.OFF, height=16, width=40, halo=3)
        with pytest.raises(TypeError):
            entry(ext, row0.to(torch.int64), 16, 9, NonmaxMode.OFF, **kw)
        with pytest.raises(ValueError):
            entry(ext, row0[:1], 16, 9, NonmaxMode.OFF, **kw)
        with pytest.raises(ValueError):
            entry(ext, row0, 16, 9, NonmaxMode.OFF, height=16, width=41, halo=4)
        with pytest.raises(ValueError):
            entry(ext[:, :8], row0, 16, 9, NonmaxMode.OFF, **kw)  # no own rows
        with pytest.raises(TypeError):
            entry(ext.to(torch.int32), row0, 16, 9, NonmaxMode.OFF, **kw)
        with pytest.raises(ValueError):
            entry(ext, row0, 16, 8, NonmaxMode.OFF, **kw)
    words = fast_cuda.detect_words_tiles(ext, row0, 16, 9, NonmaxMode.OFF, **kw)
    assert words.shape == (2, 8, 2) and words.dtype == torch.int32
    assert torch.equal(words, compact.pack_mask_words(torch.zeros((2, 8, 40), dtype=torch.bool)))
