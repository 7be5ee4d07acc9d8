"""The benchmark's data generators: the room renderer against the port's,
and the 1080p frame pool."""

import numpy as np
import pytest
import torch

from benchmark.data import frames, render

SCENE = dict(width=160, height=120, fx=130.0, fy=130.0, z_back=12.0, cell=0.3, n_boxes=10,
             noise_sigma=4.0, blur=True, vignette=0.25, seed=3, radius=2.0)


@pytest.mark.parametrize("noise_seed", [3, 11])
def test_renderer_within_one_grey_level_of_the_ports(noise_seed):
    """The torch copy renders what ``io.render.render_frame`` renders (the
    port seeds the noise with the scene's seed; the copy takes it apart)."""
    from feature_detector_fast_tpu_torch.io import render as port

    scene = {**SCENE, "seed": noise_seed}
    cfg = port.RenderConfig(**{k: v for k, v in scene.items() if k != "radius"})
    gt, imgs = render.render_circuit(scene, 8, noise_seed, "cpu", chunk=3)
    np.testing.assert_array_equal(gt, port.loop_trajectory(8, radius=2.0))
    for k in range(8):
        want = port.render_frame(gt[k], cfg, frame_id=k).astype(np.int32)
        assert np.abs(imgs[k].numpy().astype(np.int32) - want).max() <= 1


def test_noise_seed_changes_only_the_noise():
    gt = render.loop_trajectory(2)
    a = render.render_frames(gt, SCENE, 0, 1, "cpu").to(torch.int32)
    b = render.render_frames(gt, SCENE, 0, 2, "cpu").to(torch.int32)
    c = render.render_frames(gt, SCENE, 0, 1, "cpu").to(torch.int32)
    assert torch.equal(a, c)
    d = (a - b).abs()
    assert d.max() > 0 and d.float().mean() < 8  # sigma 4 noise, same room


def test_large_seeds_render():
    gt = render.loop_trajectory(1)
    f = render.render_frames(gt, SCENE, 0, (1 << 31) + 12345, "cpu")
    assert f.shape == (1, 120, 160) and f.dtype == torch.uint8


def test_pool_is_seeded_and_distinct():
    a = frames.pool(2**31 + 7, 16, 1080, 1920)
    b = frames.pool(2**31 + 7, 16, 1080, 1920)
    np.testing.assert_array_equal(a, b)
    flat = a.reshape(16, -1)
    assert len({row.tobytes() for row in flat}) == 16
    assert not np.array_equal(frames.pool(2**31 + 8, 1, 1080, 1920)[0], a[0])
    perms = frames.permutations(5, 4, 16, 16)
    assert all(sorted(p.tolist()) == list(range(16)) for p in perms)


def test_golden_copy_equals_the_repositorys_png():
    import os

    from PIL import Image

    png = os.path.join(os.path.dirname(frames.GOLDEN), "..", "..", "media", "golden_1080p.png")
    np.testing.assert_array_equal(frames.golden(), np.asarray(Image.open(png)))
