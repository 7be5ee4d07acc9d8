"""The port's public API on the CPU (``device="cpu"``, the plain PyTorch
path), against the JAX package's API and the golden pins of
tests/test_golden.py.

Keypoint lists are integer arrays, so every comparison is exact: the
tolerance is zero.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import feature_detector_fast_tpu as jax_port
from feature_detector_fast_tpu import api as jax_api
from feature_detector_fast_tpu import geometry as jax_geometry
import feature_detector_fast_tpu_torch as port
from feature_detector_fast_tpu_torch import api, cli, geometry, serving
from feature_detector_fast_tpu_torch.config import Config, NonmaxMode
from feature_detector_fast_tpu_torch.ops import compact
from feature_detector_fast_tpu_torch.utils.hashing import hash_keypoints
from feature_detector_fast_tpu_torch.utils.image import load_luma8

from test_golden import GOLDEN, GOLDEN_1080P

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
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


def to_jax(config: Config):
    return jax_port.Config(config.threshold, config.count,
                           jax_port.NonmaxMode(config.nonmax.value))


def to_port(jax_config) -> Config:
    return Config(jax_config.threshold, jax_config.count, NonmaxMode(jax_config.nonmax.value))


@pytest.fixture(scope="module")
def golden_1080p():
    return load_luma8(os.path.join(REPO, "media", "golden_1080p.png"))


def test_config_and_geometry_match_jax():
    """Same circle order, same modes, same validation as the JAX package."""
    assert geometry.CIRCLE == jax_geometry.CIRCLE
    assert (geometry.RADIUS, geometry.NORTH, geometry.EAST, geometry.SOUTH, geometry.WEST) == (
        jax_geometry.RADIUS, jax_geometry.NORTH, jax_geometry.EAST, jax_geometry.SOUTH,
        jax_geometry.WEST)
    assert [m.value for m in NonmaxMode] == [m.value for m in jax_port.NonmaxMode]
    assert Config(16.0, 9) == Config(16, 9) and isinstance(Config(16.0, 9).threshold, int)
    for bad in [dict(threshold=16.5), dict(threshold="16"), dict(threshold=True),
                dict(threshold=256), dict(threshold=-1), dict(count=8), dict(count=17),
                dict(nonmax="off")]:
        with pytest.raises((TypeError, ValueError)) as port_err:
            Config(**bad)
        with pytest.raises((TypeError, ValueError)) as jax_err:
            jax_port.Config(**bad)
        assert port_err.type is jax_err.type


@pytest.mark.parametrize("jax_config,count,kp_hash", GOLDEN, ids=str)
def test_golden_reference_frame(reference_image, jax_config, count, kp_hash):
    """detect_arrays on the 300x200 reference frame == JAX, with the pins."""
    xy = port.detect_arrays(reference_image, to_port(jax_config), device="cpu")
    assert xy.dtype == np.uint32 and xy.shape == (count, 2)
    assert hash_keypoints(xy) == kp_hash
    np.testing.assert_array_equal(xy, jax_api.detect_arrays(reference_image, jax_config))


@pytest.mark.parametrize("jax_config,count,kp_hash", GOLDEN_1080P, ids=str)
def test_golden_1080p(golden_1080p, jax_config, count, kp_hash):
    """detect_arrays on the native 1080p frame == JAX, with the pins."""
    xy = port.detect_arrays(golden_1080p, to_port(jax_config), device="cpu")
    assert len(xy) == count and hash_keypoints(xy) == kp_hash
    np.testing.assert_array_equal(xy, jax_api.detect_arrays(golden_1080p, jax_config))


def test_detect_points_and_config_method(reference_image):
    """detect / Config.detect return the same points as detect_arrays."""
    cfg = Config(16, 9, NonmaxMode.MAX_THRESHOLD)
    pts = port.detect(torch.from_numpy(reference_image), cfg, device="cpu")
    assert pts == cfg.detect(reference_image, device="cpu")
    assert pts[0] == port.Point(int(pts[0].x), int(pts[0].y))
    assert [tuple(p) for p in pts] == [
        tuple(p) for p in port.detect_arrays(reference_image, cfg, device="cpu").tolist()]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
def test_batch_arrays_and_device(rng, reference_image, mode):
    """detect_batch_arrays on a (3, H, W) batch == JAX's batch API and the
    per-frame results; detect_batch_device's counts agree."""
    batch = np.stack([reference_image, reference_image[::-1].copy(),
                      rng.integers(0, 256, reference_image.shape, np.uint8)])
    cfg = Config(16, 9, mode)
    got = api.detect_batch_arrays(batch, cfg, device="cpu")
    expect = jax_api.detect_batch_arrays(batch, to_jax(cfg))
    assert len(got) == len(expect) == 3
    for g, e, frame in zip(got, expect, batch):
        np.testing.assert_array_equal(g, e)
        np.testing.assert_array_equal(g, api.detect_arrays(frame, cfg, device="cpu"))
    words, n = api.detect_batch_device(batch, cfg, device="cpu")
    assert words.shape == (3, 200, 10) and words.dtype == torch.int32
    assert n.tolist() == [len(g) for g in got]


@pytest.mark.parametrize("k", [1, 50, 100000])
@pytest.mark.parametrize("mode", [NonmaxMode.MAX_THRESHOLD, NonmaxMode.SUM_ABSOLUTE],
                         ids=lambda m: m.value)
def test_strongest_matches_jax(reference_image, mode, k):
    """detect_strongest_arrays: same keypoints and same t_star as JAX."""
    cfg = Config(16, 9, mode)
    xy, t_star = api.detect_strongest_arrays(reference_image, cfg, k=k, device="cpu")
    j_xy, j_t = jax_api.detect_strongest_arrays(reference_image, to_jax(cfg), k=k)
    assert t_star == j_t
    np.testing.assert_array_equal(xy, j_xy)
    assert len(xy) >= min(k, len(api.detect_arrays(reference_image, cfg, device="cpu")))


def test_strongest_edge_cases():
    """A frame with no keypoints gives t_star 4096 and an empty list, as in
    JAX; nonmax OFF has no score and is refused."""
    flat = np.full((64, 96), 77, np.uint8)
    cfg = Config(16, 9, NonmaxMode.SUM_ABSOLUTE)
    xy, t_star = api.detect_strongest_arrays(flat, cfg, k=10, device="cpu")
    j_xy, j_t = jax_api.detect_strongest_arrays(flat, to_jax(cfg), k=10)
    assert t_star == j_t == 4096 and xy.shape == (0, 2) and len(j_xy) == 0
    with pytest.raises(ValueError):
        api.detect_strongest_arrays(flat, Config(16, 9, NonmaxMode.OFF), k=10, device="cpu")


def test_pipeline_on_cpu(rng, reference_image):
    """DetectorPipeline(depth=2) over 4 batches == detect_batch_arrays."""
    cfg = Config(16, 9, NonmaxMode.SUM_ABSOLUTE)
    batches = [np.stack([np.roll(reference_image, 11 * (2 * j + i), axis=1) for i in range(2)])
               for j in range(4)]
    pipe = serving.DetectorPipeline(cfg, depth=2, device="cpu")
    out = []
    for b in batches:
        pipe.submit(b)
        out.extend(pipe.ready())
        assert len(pipe._inflight) <= 2
    out.extend(pipe.drain())
    assert len(out) == 4
    for b, lists in zip(batches, out):
        for got, expect in zip(lists, api.detect_batch_arrays(b, cfg, device="cpu")):
            np.testing.assert_array_equal(got, expect)
    with pytest.raises(ValueError):
        pipe.submit(batches[0][0])


def test_cli_on_cpu(tmp_path, capsys):
    """The CLI's positional contract with --device cpu: the sum_absolute
    default finds 135 keypoints on the reference frame."""
    out = tmp_path / "out.png"
    src = os.path.join(REPO, "media", "Screenshot315_torch_grey.png")
    assert cli.main([src, str(out), "--device", "cpu"]) == 0
    assert "found 135 keypoints" in capsys.readouterr().out
    lines = (tmp_path / "out.txt").read_text().splitlines()
    assert len(lines) == 135 and out.exists()
    assert cli.main([src, str(out), "16", "9", "max_threshold", "--device", "cpu"]) == 0
    assert len((tmp_path / "out.txt").read_text().splitlines()) == 131


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor the JAX
    package (whose __init__ imports jax)."""
    code = (
        "import sys\n"
        "import feature_detector_fast_tpu_torch\n"
        "from feature_detector_fast_tpu_torch import api, cli, serving\n"
        "from feature_detector_fast_tpu_torch.models import brief, match, pyramid\n"
        "from feature_detector_fast_tpu_torch.ops import brief_cuda, compact, fast, fast_cuda\n"
        "from feature_detector_fast_tpu_torch.ops import patch_cuda, windows\n"
        "from feature_detector_fast_tpu_torch.utils import cuda_build, hashing, image\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'feature_detector_fast_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_default_device_is_cuda():
    """Without CUDA the default device="cuda" raises: no silent move to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device works here")
    img = np.zeros((32, 32), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.detect_arrays(img)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.detect_batch_device(img[None])
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.DetectorPipeline()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([os.path.join(REPO, "media", "Screenshot315_torch_grey.png"), "/dev/null"])


def test_image_and_hash_utils_match_jax(reference_image):
    """The port's numpy/PIL copies of image loading, overlay drawing and
    golden hashing give the JAX package's results exactly."""
    from feature_detector_fast_tpu.utils import hashing as jax_hashing
    from feature_detector_fast_tpu.utils import image as jax_image
    from feature_detector_fast_tpu_torch.utils import hashing, image

    src = os.path.join(REPO, "media", "Screenshot315_torch.png")  # the RGB original
    np.testing.assert_array_equal(image.load_luma8(src), jax_image.load_luma8(src))
    pts = [(0, 0), (1, 5), (299, 199), (150, 100), (298, 1)]
    np.testing.assert_array_equal(image.draw_keypoints(reference_image, pts, size=3),
                                  jax_image.draw_keypoints(reference_image, pts, size=3))
    assert hashing.hash_image(reference_image) == jax_hashing.hash_image(reference_image)
    assert hashing.hash_keypoints(pts) == jax_hashing.hash_keypoints(pts)


def test_input_validation():
    """Non-u8 or wrong-rank input is refused, as in the JAX API."""
    with pytest.raises(TypeError):
        port.detect_arrays(np.zeros((32, 32), np.float32), device="cpu")
    with pytest.raises(ValueError):
        port.detect_arrays(np.zeros((1, 32, 32), np.uint8), device="cpu")
    with pytest.raises(ValueError):
        api.detect_batch_arrays(np.zeros((32, 32), np.uint8), device="cpu")
    assert compact.split_frames(torch.zeros((0, 3), dtype=torch.int64), 2)[1].shape == (0, 2)
