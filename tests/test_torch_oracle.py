"""The port's FAST oracles and reference-API helpers against the JAX
package's: ``oracle.naive`` (scalar Python) and ``oracle.native`` (scalar
C++ built with g++ into the port's ``_build/``) at 3 modes x counts 9..16 on
seeded random frames and the committed 300 x 200 frame, the goldens
309 / 131 / 135 through the native oracle, and ``utils.image``,
``geometry`` and ``ops.windows.ring_windowed``.

Keypoint lists, scores and images are integers, so every comparison is
exact: the tolerance is zero.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import feature_detector_fast_tpu as jax_port
from feature_detector_fast_tpu import geometry as jax_geometry
from feature_detector_fast_tpu.ops import windows as jax_windows
from feature_detector_fast_tpu.oracle import naive as jax_naive
from feature_detector_fast_tpu.oracle import native as jax_native
from feature_detector_fast_tpu.utils import image as jax_image
from feature_detector_fast_tpu_torch import geometry
from feature_detector_fast_tpu_torch.config import Config, NonmaxMode
from feature_detector_fast_tpu_torch.ops import windows
from feature_detector_fast_tpu_torch.oracle import naive, native
from feature_detector_fast_tpu_torch.utils import image, native_build

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
CONFIGS = [(mode, count) for mode in NonmaxMode for count in range(9, 17)]
GOLDEN = {NonmaxMode.OFF: 309, NonmaxMode.MAX_THRESHOLD: 131, NonmaxMode.SUM_ABSOLUTE: 135}


def both(threshold: int, count: int, mode: NonmaxMode):
    return (Config(threshold, count, mode),
            jax_port.Config(threshold, count, jax_port.NonmaxMode(mode.value)))


def points(pts) -> list:
    return [(int(p[0]), int(p[1])) for p in pts]


@pytest.fixture(scope="module")
def frames():
    """Seeded random frames (odd widths, one of the kernels' test widths)
    and the committed 300 x 200 frame."""
    rng = np.random.default_rng(0x5EED)
    return {"rand_26x32": rng.integers(0, 256, (26, 32), np.uint8),
            "rand_61x157": rng.integers(0, 256, (61, 157), np.uint8),
            "ref_200x300": image.load_luma8(os.path.join(REPO, "media",
                                                         "Screenshot315_torch_grey.png"))}


@pytest.mark.parametrize("mode,count", CONFIGS, ids=lambda v: str(getattr(v, "value", v)))
def test_naive_matches_jax(frames, mode, count):
    """The scalar Python oracle == the JAX package's, on a random frame at
    thresholds 0, 16 and 60 and on the 300 x 200 frame at 16."""
    for name, t in (("rand_26x32", 0), ("rand_26x32", 16), ("rand_26x32", 60),
                    ("ref_200x300", 16)):
        cfg, jcfg = both(t, count, mode)
        got = points(naive.detector(frames[name], cfg))
        assert got == points(jax_naive.detector(frames[name], jcfg))


@pytest.mark.parametrize("mode,count", CONFIGS, ids=lambda v: str(getattr(v, "value", v)))
def test_native_matches_jax(frames, mode, count):
    """The C++ oracle == the JAX package's, on the random frames at
    thresholds 0, 16 and 60 and on the 300 x 200 frame at 16; and on the
    small frame == the port's scalar Python oracle."""
    for name, img in frames.items():
        for t in ((0, 16, 60) if name.startswith("rand") else (16,)):
            cfg, jcfg = both(t, count, mode)
            got = native.detect_arrays(img, cfg)
            assert got.dtype == np.uint32 and got.shape[1:] == (2,)
            np.testing.assert_array_equal(got, jax_native.detect_arrays(img, jcfg))
    cfg, _ = both(16, count, mode)
    assert points(native.detector(frames["rand_26x32"], cfg)) == points(
        naive.detector(frames["rand_26x32"], cfg))


@pytest.mark.parametrize("mode", list(NonmaxMode), ids=lambda m: m.value)
def test_native_goldens(frames, mode):
    """309 / 131 / 135 keypoints on the committed frame at t=16, n=9."""
    assert len(native.detect_arrays(frames["ref_200x300"], Config(16, 9, mode))) == GOLDEN[mode]


def test_scores_and_keypoint_probe_match_jax(frames):
    """The scalar scores and the keypoint predicate, native and naive, ==
    the JAX package's at a grid of pixels."""
    img = frames["rand_26x32"]
    for x in range(3, 29, 2):
        for y in range(3, 23, 2):
            for count in (9, 12, 16):
                want = jax_native.score_max_threshold(img, (x, y), count)
                assert native.score_max_threshold(img, (x, y), count) == want
                assert naive.score_max_threshold(img, (x, y), count) == want
                assert (native.is_keypoint(img, (x, y), 16, count)
                        == jax_native.is_keypoint(img, (x, y), 16, count))
            want = jax_native.score_sum_abs(img, (x, y), 16)
            assert native.score_sum_abs(img, (x, y), 16) == want
            assert naive.score_sum_abs(img, (x, y), 16) == want
    ring = [int(v) for v in img[0, :16]]
    assert (naive.score_sum_abs_ring(int(img[1, 1]), ring, 10)
            == jax_naive.score_sum_abs_ring(int(img[1, 1]), ring, 10))


def test_native_build_cached_in_port_build_dir():
    """The oracle library lands in the port's ``_build/``, named by the
    source's hash; a second build returns the same file."""
    src = os.path.join(os.path.dirname(native.__file__), "native_src", "fast_oracle.cpp")
    path = native_build.build_shared_lib(src)
    assert os.path.dirname(path) == native_build.BUILD_DIR and os.path.exists(path)
    assert native_build.build_shared_lib(src) == path


def test_oracles_import_no_jax():
    """The oracles and the API helpers import neither JAX nor the JAX
    package (a fresh interpreter)."""
    code = ("import sys\n"
            "from feature_detector_fast_tpu_torch.oracle import naive, native\n"
            "from feature_detector_fast_tpu_torch.utils import image, native_build\n"
            "from feature_detector_fast_tpu_torch import geometry\n"
            "from feature_detector_fast_tpu_torch.ops import windows\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'feature_detector_fast_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_image_helpers_match_jax(frames, tmp_path):
    """Luma16, the /3 grey, the RGB loader, the circle image and the colours
    == the JAX package's."""
    rgb = np.random.default_rng(1).integers(0, 256, (7, 9, 3), np.uint8)
    for name in ("rgb_to_luma16_sum", "rgb_to_grey_third", "rgb_to_luma8"):
        got, want = getattr(image, name)(rgb), getattr(jax_image, name)(rgb)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "rgb.png")
    image.save_image(rgb, path)
    np.testing.assert_array_equal(image.load_rgb8(path), jax_image.load_rgb8(path))
    np.testing.assert_array_equal(image.load_rgb8(path), rgb)
    np.testing.assert_array_equal(image.make_circle_image(), jax_image.make_circle_image())
    assert (image.WHITE, image.RED, image.GREEN, image.BLUE) == (
        jax_image.WHITE, jax_image.RED, jax_image.GREEN, jax_image.BLUE)


def test_geometry_helpers_match_jax():
    """circle, point (wrapping) and calculate_offsets == the JAX package's."""
    assert geometry.circle() == jax_geometry.circle() and geometry.CIRCLE_LEN == 16
    for i in (-17, -1, 0, 5, 15, 16, 33):
        assert geometry.point(i) == jax_geometry.point(i)
    for w in (1, 9, 157, 1920):
        assert geometry.calculate_offsets(w) == jax_geometry.calculate_offsets(w)


@pytest.mark.parametrize("n", [1, 5, 9, 13, 16])
def test_ring_windowed_matches_jax(n):
    """All 16 circular windowed reductions (min, max, add, AND) == the JAX
    package's helper, and == a direct fold."""
    rng = np.random.default_rng(n)
    planes = [rng.integers(-50, 50, (3, 4)) for _ in range(16)]
    for combine in (np.minimum, np.maximum, np.add, np.bitwise_and):
        got = windows.ring_windowed(planes, n, combine)
        want = jax_windows.ring_windowed(planes, n, combine)
        assert len(got) == 16
        for s in range(16):
            np.testing.assert_array_equal(got[s], want[s])
            direct = planes[s]
            for k in range(1, n):
                direct = combine(direct, planes[(s + k) % 16])
            np.testing.assert_array_equal(got[s], direct)
    with pytest.raises(ValueError):
        windows.ring_windowed(planes, 17, np.minimum)
