"""The port's patch-extraction wrappers and patched BRIEF on the CPU,
against the JAX package.

Same seeded numpy inputs through ``feature_detector_fast_tpu.ops.patch_pallas``
(interpret mode, as tests/test_patch_pallas.py runs it) and
``feature_detector_fast_tpu_torch.ops.patch_cuda``.  Every output is an
integer, so the tolerance is zero, except for the orientation-bin rule of
tests/test_torch_brief.py.
"""

import numpy as np
import pytest
import torch

import conftest
from feature_detector_fast_tpu.models import brief as jax_brief
from feature_detector_fast_tpu.ops import patch_pallas
from feature_detector_fast_tpu_torch.models import brief
from feature_detector_fast_tpu_torch.ops import patch_cuda
from test_torch_brief import assert_bins_agree, near_half_bins, to_port, u32

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


def fuzz_xy(rng, h: int, w: int, k: int) -> np.ndarray:
    """(K, 2) int32 coordinates, in range, on the border and beyond it."""
    xy = np.stack([rng.integers(-20, w + 20, k), rng.integers(-20, h + 20, k)], axis=-1)
    xy[:4] = [[0, 0], [w - 1, h - 1], [17, h - 18], [w - 16, 15]]
    return xy.astype(np.int32)


def test_constants_match_jax():
    assert (patch_cuda.PATCH, patch_cuda.WIN_H, patch_cuda.LANES, patch_cuda.RAW_SHIFT) == (
        patch_pallas.PATCH, patch_pallas.WIN_H, patch_pallas.LANES, patch_pallas.RAW_SHIFT)


@pytest.mark.parametrize("shape", SHAPES)
def test_extract_patches_matches_jax(rng, shape):
    """Whole (32, 128) windows equal JAX's, zero cells past the frame
    included, for coordinates anywhere (clamped to [15, W-16] x [15, H-16]);
    K = 37 is not a multiple of anything."""
    h, w = shape
    planes = rng.integers(0, 6376, (2, h, w)).astype(np.int32)
    xy = np.stack([fuzz_xy(rng, h, w, 37) for _ in range(2)])
    got = patch_cuda.extract_patches(torch.from_numpy(planes), torch.from_numpy(xy))
    assert got.shape == (2, 37, patch_cuda.WIN_H, patch_cuda.LANES) and got.dtype == torch.int32
    for i in range(2):
        want = np.asarray(patch_pallas.extract_patches(planes[i], xy[i], interpret=True))
        np.testing.assert_array_equal(got[i].numpy(), want)
    # The bottom-right keypoint's window leaves the frame after row and column 30.
    assert (got[:, 1, 31:] == 0).all() and (got[:, 1, :, 31:] == 0).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_extract_windows_fused_matches_jax(rng, shape, monkeypatch):
    """The 31 x 31 windows equal JAX's resident kernel and its strip-DMA
    fallback (forced on the JAX side by a zero residency budget) at every
    cell, for coordinates anywhere (clamped to [17, W-18] x [17, H-18])."""
    h, w = shape
    frames = rng.integers(0, 256, (2, h, w), np.uint8)
    xy = np.stack([fuzz_xy(rng, h, w, 21) for _ in range(2)])
    got = patch_cuda.extract_windows_fused(torch.from_numpy(frames), torch.from_numpy(xy))
    assert got.shape == (2, 21, patch_cuda.PATCH, patch_cuda.PATCH) and got.dtype == torch.int32
    n = patch_cuda.PATCH
    for i in range(2):
        want = np.asarray(patch_pallas.extract_windows_fused(frames[i], xy[i], interpret=True))
        np.testing.assert_array_equal(got[i].numpy(), want[:, :n, :n])
    monkeypatch.setattr(patch_pallas, "_RESIDENT_BYTES_MAX", 0)
    strip = np.asarray(patch_pallas.extract_windows_fused.__wrapped__(frames[0], xy[0], 0, True))
    np.testing.assert_array_equal(got[0].numpy(), strip[:, :n, :n])


def test_extract_windows_fused_contents(rng):
    """blur5 | raw << 13 at every cell, against box_blur5 directly."""
    h, w = 61, 83
    img = rng.integers(0, 256, (h, w), np.uint8)
    xy = np.array([[17, 17], [41, 30], [w - 18, h - 18]], np.int32)
    got = patch_cuda.extract_windows_fused(torch.from_numpy(img)[None], torch.from_numpy(xy)[None])
    blur = np.asarray(jax_brief.box_blur5(img))
    for i, (x, y) in enumerate(xy):
        cells = np.s_[y - 15: y + 16, x - 15: x + 16]
        np.testing.assert_array_equal(got[0, i].numpy(), blur[cells] | (img[cells].astype(np.int32) << 13))


def test_wrappers_refuse_bad_arguments():
    """Frames under 35 x 35 (as in JAX), mismatched or non-integer
    coordinates and wrong dtypes are refused; the CPU path counts no
    launch."""
    before = dict(patch_cuda.LAUNCHES)
    xy = torch.zeros((1, 3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="too small"):
        patch_cuda.extract_windows_fused(torch.zeros((1, 34, 40), dtype=torch.uint8), xy)
    with pytest.raises(ValueError, match="image too small"):
        patch_pallas.extract_windows_fused(np.zeros((34, 40), np.uint8), np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError):
        patch_cuda.extract_windows_fused(torch.zeros((2, 40, 40), dtype=torch.uint8), xy)
    with pytest.raises(TypeError):
        patch_cuda.extract_patches(torch.zeros((1, 40, 40), dtype=torch.uint8), xy)
    with pytest.raises(TypeError):
        patch_cuda.extract_patches(torch.zeros((1, 40, 40), dtype=torch.int32), xy.float())
    patch_cuda.extract_windows_fused(torch.zeros((1, 40, 40), dtype=torch.uint8), xy)
    patch_cuda.extract_patches(torch.zeros((1, 40, 40), dtype=torch.int32), xy.long())
    assert patch_cuda.LAUNCHES == before


@pytest.mark.parametrize("oriented", [False, True], ids=["plain", "oriented"])
@pytest.mark.parametrize("shape", SHAPES)
def test_describe_patched_matches_jax(rng, shape, oriented):
    """describe_patched equals JAX's describe_patched (interpret mode) and
    the port's sparse route at every valid slot; validity is exact."""
    h, w = shape
    img = rng.integers(0, 256, shape, np.uint8)
    kps = conftest.fuzz_keypoints(rng, h, w, 64)
    desc, valid = brief.describe_patched(torch.from_numpy(img), to_port(kps), oriented)
    j_desc, j_valid = jax_brief.describe_patched(img, kps, oriented, interpret=True)
    v = np.array(j_valid)
    assert v.any()
    np.testing.assert_array_equal(valid.numpy(), v)
    agree = np.ones(len(v), bool)
    if oriented:
        agree = assert_bins_agree(
            brief.orientation_bins(torch.from_numpy(img), to_port(kps)).numpy(),
            jax_brief.orientation_bins(img, kps), near_half_bins(img, kps.xy))
    np.testing.assert_array_equal(u32(desc)[v & agree], u32(j_desc)[v & agree])
    sparse = (brief.describe_oriented if oriented else brief.describe)(
        torch.from_numpy(img), to_port(kps))[0]
    np.testing.assert_array_equal(u32(desc)[v], u32(sparse)[v])


def test_describe_patched_batch(rng):
    """A (2, H, W) batch with (2, K) keypoints equals the frames one by one."""
    frames = rng.integers(0, 256, (2, 80, 96), np.uint8)
    kps = [to_port(conftest.fuzz_keypoints(rng, 80, 96, 16)) for _ in range(2)]
    both = brief.Keypoints(*(torch.stack([k[i] for k in kps]) for i in range(3)))
    for oriented in (False, True):
        desc, valid = brief.describe_patched(torch.from_numpy(frames), both, oriented)
        for i in range(2):
            one, one_valid = brief.describe_patched(torch.from_numpy(frames[i]), kps[i], oriented)
            assert torch.equal(one, desc[i]) and torch.equal(one_valid, valid[i])
