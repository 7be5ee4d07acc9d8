"""The port's io modules (warp, kitti, tum) against the JAX package's.

All three are host numpy in both packages, so the outputs are equal: the
warp sequences of the reference frame (clean and through the render
module's degradations), homographies and essential matrices, and the KITTI
and TUM loaders on trees built in ``tmp_path`` (tests/test_io_utils.py's
fixtures).  Cameras come from the port's ``models.twoview``.
"""

import dataclasses
import os

import numpy as np
import pytest

from feature_detector_fast_tpu.io import kitti as jkitti
from feature_detector_fast_tpu.io import render as jrender
from feature_detector_fast_tpu.io import tum as jtum
from feature_detector_fast_tpu.io import warp as jwarp
from feature_detector_fast_tpu.models import twoview as jtwoview
from feature_detector_fast_tpu_torch.io import kitti, render, tum, warp
from feature_detector_fast_tpu_torch.models import twoview
from test_io_utils import write_kitti_fixture, write_tum_fixture


@pytest.fixture(scope="module")
def frame(reference_image):
    return reference_image[:120, :160].copy()


def test_warp_sequence_matches_jax(frame):
    cam = twoview.Camera(150.0, 150.0, 80.0, 60.0)
    jcam = jtwoview.Camera(*cam)
    w2c = warp.plane_trajectory(4, depth=5.0)
    np.testing.assert_array_equal(w2c, jwarp.plane_trajectory(4, depth=5.0))
    np.testing.assert_array_equal(warp.plane_homographies(w2c, cam, 5.0),
                                  jwarp.plane_homographies(w2c, jcam, 5.0))
    kw = dict(noise_sigma=4.0, blur=True, vignette=0.25, seed=3)
    for degrade, jdegrade in ((None, None), (render.RenderConfig(**kw),
                                             jrender.RenderConfig(**kw))):
        frames, Hs = warp.warp_sequence(frame, w2c, cam, 5.0, degrade)
        jframes, jHs = jwarp.warp_sequence(frame, w2c, jcam, 5.0, jdegrade)
        np.testing.assert_array_equal(Hs, jHs)
        for a, b in zip(frames, jframes):
            assert a.dtype == np.uint8 and a.shape == frame.shape
            np.testing.assert_array_equal(a, b)
    assert (frames[1] != frames[0]).any()
    xy = np.array([[10.0, 20.0], [80.5, 60.25], [159.0, 119.0]])
    np.testing.assert_array_equal(warp.project_through(Hs[2], xy),
                                  jwarp.project_through(Hs[2], xy))
    np.testing.assert_array_equal(warp.warp_image(frame, Hs[3], fill=7.0),
                                  jwarp.warp_image(frame, Hs[3], fill=7.0))
    np.testing.assert_array_equal(warp.exact_essential(w2c[2]), jwarp.exact_essential(w2c[2]))


def test_kitti_load_sequence_matches_jax(tmp_path):
    seq_dir = write_kitti_fixture(str(tmp_path), n=5)
    for max_frames in (None, 3):
        paths, poses, cam = kitti.load_sequence(seq_dir, max_frames=max_frames)
        jpaths, jposes, jcam = jkitti.load_sequence(seq_dir, max_frames=max_frames)
        assert paths == jpaths and len(paths) == (max_frames or 5)
        np.testing.assert_array_equal(poses, jposes)
        assert isinstance(cam, twoview.Camera) and tuple(cam) == tuple(jcam)
    np.testing.assert_allclose(poses[:, 2, 3], np.arange(3))
    calib = os.path.join(seq_dir, "calib.txt")
    assert tuple(kitti.read_calib(calib, 1)) == tuple(jkitti.read_calib(calib, 1))
    with pytest.raises(ValueError, match="P2:"):
        kitti.read_calib(calib, 2)
    os.remove(os.path.join(str(tmp_path), "poses", "04.txt"))
    paths, poses, _ = kitti.load_sequence(seq_dir)
    assert poses is None and len(paths) == 5


def test_tum_load_sequence_matches_jax(tmp_path):
    root = str(tmp_path / "seq")
    write_tum_fixture(root)
    for max_frames in (None, 2):
        paths, poses = tum.load_sequence(root, max_frames=max_frames)
        jpaths, jposes = jtum.load_sequence(root, max_frames=max_frames)
        assert paths == jpaths and len(paths) == (max_frames or 5)
        np.testing.assert_array_equal(poses, jposes)
    np.testing.assert_allclose(poses[:, 0, 3], np.arange(2) * 0.5)
    gt = os.path.join(root, "groundtruth.txt")
    for a, b in zip(tum.groundtruth_poses(gt), jtum.groundtruth_poses(gt)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("q", [(0, 0, np.sqrt(0.5), np.sqrt(0.5)), (0.1, -0.7, 0.3, 0.2),
                               (0, 0, 0, 0)])
def test_quaternion_and_association_match_jax(q):
    q = np.asarray(q, float)
    np.testing.assert_array_equal(tum.quaternion_to_matrix(q), jtum.quaternion_to_matrix(q))
    a = [(0.0, []), (1.0, []), (2.0, []), (2.01, [])]
    b = [(0.01, []), (1.015, []), (2.005, []), (5.0, [])]
    for d in (0.001, 0.02, 10.0):
        assert tum.associate(a, b, d) == jtum.associate(a, b, d)


def test_render_config_degradations_carry_across():
    """warp_sequence reads only the degradation fields of its RenderConfig;
    the port's and the JAX package's configs have the same fields."""
    assert [f.name for f in dataclasses.fields(render.RenderConfig)] == [
        f.name for f in dataclasses.fields(jrender.RenderConfig)]
