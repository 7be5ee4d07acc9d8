"""The port's front-end -- detect, top-K, BRIEF, matching, pyramid -- on the
CPU (``device="cpu"``), against the JAX package and the golden front-end
pins.

Keypoints, validity and match indices compare exactly; descriptors compare
exactly at valid slots (every route leaves garbage elsewhere), with the
orientation-bin rule of tests/test_torch_brief.py for steered BRIEF.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from feature_detector_fast_tpu.models import brief as jax_brief
from feature_detector_fast_tpu.models import match as jax_match
from feature_detector_fast_tpu.models import pyramid as jax_pyramid
from feature_detector_fast_tpu_torch.models import brief, match, pyramid
from feature_detector_fast_tpu_torch.utils.hashing import hash_features
from feature_detector_fast_tpu_torch.utils.image import load_luma8
from test_torch_brief import assert_bins_agree, near_half_bins, u32

REPO = os.path.join(os.path.dirname(__file__), os.pardir)

#: Front-end pins, computed with the JAX package on the CPU
#: (``brief.detect_and_describe``, SumAbsolute t=16 n=9) and hashed with
#: ``utils.hashing.hash_features``: (frame, k, oriented) -> hash.
#: chip_smoke.py holds the port's CUDA path to the same numbers.
FEATURE_PINS = {
    ("reference", 1000, False): 0x9DFC8FB5BDCBF569,
    ("reference", 1000, True): 0x388726B3B877F7CD,
    ("reference", 2048, False): 0x9DFC8FB5BDCBF569,
    ("reference", 2048, True): 0x388726B3B877F7CD,
    ("1080p", 1000, False): 0x8EE8957A31276C4B,
    ("1080p", 1000, True): 0xC7C83C1D8AFCFD6A,
    ("1080p", 2048, False): 0xAF7E3C6B14A54E15,
    ("1080p", 2048, True): 0xCC085CBB02549D45,
}
#: Matches between frames 0 and 1 of chip_smoke.py's batch (the 1080p frame
#: rolled by (7 i, 97 i)), k=1000, plain and oriented (JAX package, CPU).
MATCH_PIN = {False: 926, True: 926}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs under pytest-xdist with a worker per core; torch's own
    intra-op thread pool would oversubscribe the cores and slow every
    worker, so these tests run torch single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames(reference_image):
    return {"reference": reference_image,
            "1080p": load_luma8(os.path.join(REPO, "media", "golden_1080p.png"))}


def assert_features_equal(got, want, image=None, oriented=False):
    """Port (Keypoints, desc, dvalid) == JAX's: keypoints and validity
    exactly, descriptors at valid slots (where the bins agree, if steered)."""
    (kps, desc, dvalid), (j_kps, j_desc, j_dvalid) = got, want
    for g, e in zip(kps, j_kps):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    v = np.array(j_dvalid)
    np.testing.assert_array_equal(dvalid.numpy(), v)
    if oriented:
        xy = kps.xy.numpy()
        v &= assert_bins_agree(
            brief.orientation_bins(torch.from_numpy(image), kps).numpy(),
            jax_brief.orientation_bins(image, j_kps), near_half_bins(image, xy))
    np.testing.assert_array_equal(u32(desc)[v], u32(j_desc)[v])


@pytest.mark.parametrize("oriented", [False, True], ids=["plain", "oriented"])
@pytest.mark.parametrize("k", [128, 256])
def test_detect_and_describe_matches_jax(reference_image, k, oriented):
    got = brief.detect_and_describe(reference_image, 16, 9, k, oriented, device="cpu")
    assert got[1].shape == (k, brief.WORDS) and got[1].dtype == torch.int32
    want = jax_brief.detect_and_describe(jnp.asarray(reference_image), 16, 9, k, oriented)
    assert int(got[2].sum()) > 50
    assert_features_equal(got, want, reference_image, oriented)


def test_detect_and_describe_batch(reference_image):
    """The (B, H, W) form equals the frames one by one (numpy and tensor
    input alike)."""
    batch = np.stack([reference_image, np.roll(reference_image, (5, 9), axis=(0, 1))])
    for oriented in (False, True):
        kps, desc, dvalid = brief.detect_and_describe_batch(
            torch.from_numpy(batch), 16, 9, 128, oriented, device="cpu")
        assert kps.xy.shape == (2, 128, 2) and desc.shape == (2, 128, brief.WORDS)
        for i, f in enumerate(batch):
            one = brief.detect_and_describe(f, 16, 9, 128, oriented, device="cpu")
            for g, e in zip((*kps, desc, dvalid), (*one[0], *one[1:])):
                assert torch.equal(g[i], e)


@pytest.mark.parametrize("key", sorted(FEATURE_PINS, key=str), ids=str)
def test_feature_pins(frames, key):
    """The CPU path reproduces the JAX-computed front-end hashes."""
    name, k, oriented = key
    kps, desc, dvalid = brief.detect_and_describe(frames[name], 16, 9, k, oriented, device="cpu")
    assert hash_features(kps.xy, kps.score, kps.valid, desc, dvalid) == FEATURE_PINS[key]


def test_match_pin(frames):
    """Frames 0 and 1 of chip_smoke.py's rolled batch: the pinned number of
    matches, plain and oriented."""
    pair = np.stack([np.roll(frames["1080p"], (7 * i, 97 * i), axis=(0, 1)) for i in range(2)])
    for oriented in (False, True):
        _, desc, dvalid = brief.detect_and_describe_batch(pair, 16, 9, 1000, oriented, device="cpu")
        m = match.match(desc[0], dvalid[0], desc[1], dvalid[1])
        assert int((m.idx_b >= 0).sum()) == MATCH_PIN[oriented]


def test_match_shifted_frame(reference_image):
    """Detect+describe a frame and a shifted copy: the matches equal JAX's
    and overwhelmingly agree with the known shift."""
    dx, dy = 7, 4
    img2 = np.roll(np.roll(reference_image, dy, axis=0), dx, axis=1)
    k1, d1, v1 = brief.detect_and_describe(reference_image, 16, 9, 256, device="cpu")
    k2, d2, v2 = brief.detect_and_describe(img2, 16, 9, 256, device="cpu")
    m = match.match(d1, v1, d2, v2)
    pa, pb, ok = match.match_points(k1.xy, k2.xy, m)
    j1 = jax_brief.detect_and_describe(jnp.asarray(reference_image), 16, 9, 256)
    j2 = jax_brief.detect_and_describe(jnp.asarray(img2), 16, 9, 256)
    jm = jax_match.match(j1[1], j1[2], j2[1], j2[2])
    np.testing.assert_array_equal(m.idx_b.numpy(), np.asarray(jm.idx_b))
    np.testing.assert_array_equal(m.dist.numpy(), np.asarray(jm.dist))
    ok = ok.numpy()
    assert ok.sum() >= 50
    delta = (pb - pa).numpy()[ok]
    assert ((delta[:, 0] == dx) & (delta[:, 1] == dy)).mean() > 0.9


def test_downsample_and_pyramid_match_jax(rng):
    img = rng.integers(0, 256, (2, 256, 321), np.uint8)
    got = pyramid.downsample2(torch.from_numpy(img))
    assert got.shape == (2, 128, 160) and got.dtype == torch.uint8
    for g, f in zip(got, img):
        np.testing.assert_array_equal(g.numpy(), np.asarray(jax_pyramid.downsample2(jnp.asarray(f))))
    lv = pyramid.build_pyramid(torch.from_numpy(img[0]), 4)
    assert [tuple(x.shape) for x in lv] == [(256, 321), (128, 160), (64, 80)]


def test_multiscale_matches_jax(reference_image):
    """detect_and_describe_multiscale on a 128 x 160 crop, 2 levels."""
    crop = np.ascontiguousarray(reference_image[40:168, 60:220])
    f = pyramid.detect_and_describe_multiscale(crop, 16, 9, k_per_level=64, n_levels=2,
                                               device="cpu")
    j = jax_pyramid.detect_and_describe_multiscale(jnp.asarray(crop), 16, 9, 64, 2)
    for name in ("xy0", "xy", "level", "score", "valid"):
        np.testing.assert_array_equal(getattr(f, name).numpy(), np.asarray(getattr(j, name)), name)
    v = np.asarray(j.valid)
    assert v[:64].sum() > 10 and v[64:].sum() > 0
    np.testing.assert_array_equal(u32(f.desc)[v], u32(j.desc)[v])


def test_default_device_is_cuda(reference_image):
    """Without CUDA the default device="cuda" raises: no silent move to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device works here")
    with pytest.raises(RuntimeError, match="CUDA"):
        brief.detect_and_describe(reference_image, 16, 9, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        pyramid.detect_and_describe_multiscale(reference_image, 16, 9, 64)
