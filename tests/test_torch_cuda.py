"""The CUDA kernels on the card: marked ``cuda``, skipped where there is none.

Run them on a machine with an NVIDIA GPU (which need not have JAX, so the
JAX-side conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Kernels and plain versions agree exactly (integer outputs: tolerance zero).
"""

import os

import numpy as np
import pytest
import torch

import feature_detector_fast_tpu_torch as port
from feature_detector_fast_tpu_torch.config import Config, NonmaxMode
from feature_detector_fast_tpu_torch.models import brief
from feature_detector_fast_tpu_torch.ops import brief_cuda, compact, fast, fast_cuda, patch_cuda
from feature_detector_fast_tpu_torch.utils.hashing import hash_keypoints
from feature_detector_fast_tpu_torch.utils.image import load_luma8

pytestmark = pytest.mark.cuda

REPO = os.path.join(os.path.dirname(__file__), os.pardir)


@pytest.fixture()
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("mode", list(NonmaxMode), ids=lambda m: m.value)
def test_kernels_match_plain(device, mode):
    """Both entry points == the plain version on the card, counts 9..=16."""
    imgs = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (2, 61, 157), np.uint8)).to(device)
    for count in range(9, 17):
        for t in (0, 16):
            mask, score = fast.detect_dense(imgs, t, count, mode)
            before = dict(fast_cuda.LAUNCHES)
            words = fast_cuda.detect_words(imgs, t, count, mode)
            k_mask, k_score = fast_cuda.detect_dense(imgs, t, count, mode)
            torch.cuda.synchronize()
            assert fast_cuda.LAUNCHES == {**before, "words": before["words"] + 1,
                                          "dense": before["dense"] + 1}
            assert torch.equal(words, compact.pack_mask_words(mask))
            assert torch.equal(k_mask.to(torch.int32), mask.to(torch.int32))
            assert torch.equal(k_score.to(torch.int32), score.to(torch.int32))


@pytest.mark.parametrize("shape", [(1, 7, 9), (3, 45, 157), (2, 37, 1931), (1, 70, 8200)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_plain_ragged(device, shape):
    """Both entry points == the plain version on widths 9, 157, 1931 and 8200
    (off the 32- and 128-column grids), heights off the 32-row strip, and
    3 frames of odd H * W, so frames 1 and 2 start at unaligned addresses;
    3 modes x counts 9..=16."""
    imgs = torch.from_numpy(
        np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)).to(device)
    for mode in NonmaxMode:
        for count in range(9, 17):
            mask, score = fast.detect_dense(imgs, 16, count, mode)
            words = fast_cuda.detect_words(imgs, 16, count, mode)
            k_mask, k_score = fast_cuda.detect_dense(imgs, 16, count, mode)
            torch.cuda.synchronize()
            what = (mode.value, count)
            assert torch.equal(words, compact.pack_mask_words(mask)), what
            assert torch.equal(k_mask.to(torch.int32), mask.to(torch.int32)), what
            assert torch.equal(k_score.to(torch.int32), score.to(torch.int32)), what


def test_main_path_golden(device):
    """detect on the reference frame through the words kernel: the pins of
    tests/test_golden.py."""
    ref = load_luma8(os.path.join(REPO, "media", "Screenshot315_torch_grey.png"))
    before = fast_cuda.LAUNCHES["words"]
    for mode, n, h in [(NonmaxMode.OFF, 309, 0x9C9E48257E77AB23),
                       (NonmaxMode.MAX_THRESHOLD, 131, 0x0808251D63604630),
                       (NonmaxMode.SUM_ABSOLUTE, 135, 0x826FDD2651736590)]:
        pts = port.detect(ref, Config(16, 9, mode), device=device)
        assert len(pts) == n and hash_keypoints(pts) == h
    assert fast_cuda.LAUNCHES["words"] == before + 3


def test_rejects_non_contiguous(device):
    imgs = torch.zeros((1, 64, 48), dtype=torch.uint8, device=device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fast_cuda.detect_words(imgs, 16, 9, NonmaxMode.OFF)


@pytest.mark.parametrize("shape", [
    (2, 61, 157), (2, 256, 320), (1, 5, 7), (1, 5, 5), (3, 40, 33),
    # widths 1-3 past a lane's 2 columns and the 64-column block, heights
    # off the 32-row block, 3 frames of odd H * W (unaligned frame bases)
    (3, 65, 129), (1, 67, 130), (3, 63, 131), (2, 128, 66), (3, 37, 1931)],
    ids=lambda s: "x".join(map(str, s)))
def test_brief_words_matches_plain(device, shape):
    """The dense BRIEF kernel == its plain version on every pixel, border
    included, and counts one launch per call."""
    rng = np.random.default_rng(sum(shape))
    imgs = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(device)
    before = brief_cuda.LAUNCHES["brief_words"]
    got = brief_cuda.describe_words(imgs)
    torch.cuda.synchronize()
    assert brief_cuda.LAUNCHES["brief_words"] == before + 1
    assert torch.equal(got, brief_cuda.describe_words_plain(imgs)), shape


def test_brief_words_large_frame(device):
    """A frame of 1024 x 300000 pixels, so plane 7 starts more than 2^31
    int32s past plane 0: its last 64 rows == the plain version's on the
    frame's last 100 rows (all the rows they read, bottom clamp included)."""
    h, w = 1024, 300_000
    rng = np.random.default_rng(11)
    imgs = torch.from_numpy(rng.integers(0, 256, (1, h, w), np.uint8)).to(device)
    got = brief_cuda.describe_words(imgs)[..., -64:, :]
    assert torch.equal(got, brief_cuda.describe_words_plain(imgs[:, -100:])[..., -64:, :])


@pytest.mark.parametrize("b,h,w,k", [
    (2, 61, 157, 37), (2, 256, 320, 37), (1, 35, 35, 37),
    # K = 1, K off the 8 keypoints of a block, odd H * W frames
    (2, 61, 157, 1), (3, 45, 157, 9), (3, 67, 131, 1001)],
    ids=lambda v: str(v))
def test_patch_kernels_match_plain(device, b, h, w, k):
    """Both patch kernels == their plain versions for coordinates anywhere
    (in range, on the border, beyond every edge) and K not a multiple of
    anything; one launch each per call."""
    rng = np.random.default_rng(b * h * w + k)
    imgs = torch.from_numpy(rng.integers(0, 256, (b, h, w), np.uint8)).to(device)
    planes = torch.from_numpy(rng.integers(-2**31, 2**31, (b, h, w)).astype(np.int32)).to(device)
    xy = np.stack([rng.integers(-40, w + 40, (b, k)), rng.integers(-40, h + 40, (b, k))], -1)
    corners = [[-5, -5], [w + 5, h + 5], [-5, h + 5], [w + 5, -5]]
    xy[:, :min(k, 4)] = corners[:min(k, 4)]
    xy = torch.from_numpy(xy.astype(np.int32)).to(device)
    before = dict(patch_cuda.LAUNCHES)
    wins = patch_cuda.extract_windows_fused(imgs, xy)
    patches = patch_cuda.extract_patches(planes, xy)
    torch.cuda.synchronize()
    assert patch_cuda.LAUNCHES == {key: v + 1 for key, v in before.items()}
    assert torch.equal(wins, patch_cuda.extract_windows_plain(imgs, xy))
    assert torch.equal(patches, patch_cuda.extract_patches_plain(planes, xy))


@pytest.mark.parametrize("oriented", [False, True], ids=["plain", "oriented"])
@pytest.mark.parametrize("k", [128, 16384])
def test_frontend_cuda_matches_cpu(device, k, oriented):
    """detect_and_describe on the card (patched route for k=128 and every
    oriented call, dense route for k=16384 > brief._dense_k_min(200, 300) =
    130) == the CPU path: keypoints and validity exactly, descriptors at
    valid slots."""
    ref = load_luma8(os.path.join(REPO, "media", "Screenshot315_torch_grey.png"))
    before = (fast_cuda.LAUNCHES["dense"], brief_cuda.LAUNCHES["brief_words"],
              patch_cuda.LAUNCHES["extract_windows"])
    kps, desc, dvalid = brief.detect_and_describe(ref, 16, 9, k, oriented, device=device)
    torch.cuda.synchronize()
    dense = not oriented and k > brief._dense_k_min(*ref.shape)
    assert (fast_cuda.LAUNCHES["dense"], brief_cuda.LAUNCHES["brief_words"],
            patch_cuda.LAUNCHES["extract_windows"]) == (
        before[0] + 1, before[1] + dense, before[2] + (not dense))
    c_kps, c_desc, c_dvalid = brief.detect_and_describe(ref, 16, 9, k, oriented, device="cpu")
    for g, e in zip(kps, c_kps):
        assert torch.equal(g.cpu(), e)
    assert torch.equal(dvalid.cpu(), c_dvalid) and int(c_dvalid.sum()) > 50
    assert torch.equal(desc.cpu()[c_dvalid], c_desc[c_dvalid])


def test_new_kernels_reject_non_contiguous(device):
    imgs = torch.zeros((1, 64, 48), dtype=torch.uint8, device=device).transpose(1, 2)
    xy = torch.zeros((1, 3, 2), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        brief_cuda.describe_words(imgs)
    with pytest.raises(ValueError, match="contiguous"):
        patch_cuda.extract_windows_fused(imgs, xy)
    with pytest.raises(ValueError, match="contiguous"):
        patch_cuda.extract_patches(imgs.to(torch.int32), xy)


@pytest.mark.parametrize("mode", list(NonmaxMode), ids=lambda m: m.value)
def test_tiles_kernels_match_plain(device, mode):
    """Both row-shard entry points == the plain version on the card, counts
    9..=16, at 4-row halos over 3 shards of a 61 x 157 frame (the last
    shard padded) and at a 64-row halo; one launch each per call."""
    from feature_detector_fast_tpu_torch.parallel import spatial

    img = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (61, 157), np.uint8))
    rows = spatial.shard_rows(61, 3)
    [(_, ext4, row0)] = spatial.shard_slabs(img, [device] * 3, rows)
    wide = torch.nn.functional.pad(img, (0, 0, 64, 64 + 3 * rows - 61))
    ext64 = torch.stack([wide[s * rows:s * rows + rows + 128] for s in range(3)]).to(device)
    for ext, halo in ((ext4, 4), (ext64, 64)):
        for count in range(9, 17):
            kw = dict(height=61, width=157, halo=halo)
            p_mask, p_score = fast.detect_dense_tiles(ext, row0.tolist(), 16, count, mode, **kw)
            before = dict(fast_cuda.LAUNCHES)
            words = fast_cuda.detect_words_tiles(ext, row0, 16, count, mode, **kw)
            k_mask, k_score = fast_cuda.detect_dense_tiles(ext, row0, 16, count, mode, **kw)
            torch.cuda.synchronize()
            assert fast_cuda.LAUNCHES["words_tiles"] == before["words_tiles"] + 1
            assert fast_cuda.LAUNCHES["dense_tiles"] == before["dense_tiles"] + 1
            assert torch.equal(words, compact.pack_mask_words(p_mask))
            assert torch.equal(k_mask.to(torch.int32), p_mask.to(torch.int32))
            assert torch.equal(k_score.to(torch.int32), p_score.to(torch.int32))


@pytest.mark.parametrize("mode", list(NonmaxMode), ids=lambda m: m.value)
def test_tiles_kernels_pitch_wider_than_frame(device, mode):
    """The row-shard entry points on slabs whose pitch (163) exceeds the
    frame width (157): == the plain version and == the whole-frame kernel's
    rows, counts 9..=16."""
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.integers(0, 256, (75, 157), np.uint8))
    rows, shards, halo = 40, 2, 4
    wide = torch.nn.functional.pad(img, (0, 6, halo, halo + shards * rows - 75))
    wide[:, 157:] = torch.from_numpy(rng.integers(0, 256, (wide.shape[0], 6), np.uint8))
    ext = torch.stack([wide[s * rows:s * rows + rows + 2 * halo] for s in range(shards)]).to(device)
    row0 = torch.arange(shards, dtype=torch.int32, device=device) * rows
    kw = dict(height=75, width=157, halo=halo)
    for count in range(9, 17):
        p_mask, p_score = fast.detect_dense_tiles(ext, row0.tolist(), 16, count, mode, **kw)
        words = fast_cuda.detect_words_tiles(ext, row0, 16, count, mode, **kw)
        k_mask, k_score = fast_cuda.detect_dense_tiles(ext, row0, 16, count, mode, **kw)
        w_mask, w_score = fast_cuda.detect_dense(img[None].to(device), 16, count, mode)
        torch.cuda.synchronize()
        assert torch.equal(words, compact.pack_mask_words(p_mask)), count
        assert torch.equal(k_mask.to(torch.int32), p_mask.to(torch.int32)), count
        assert torch.equal(k_score.to(torch.int32), p_score.to(torch.int32)), count
        assert torch.equal(k_mask.reshape(-1, 157)[:75], w_mask[0]), count
        assert torch.equal(k_score.reshape(-1, 157)[:75], w_score[0]), count


def test_spatial_list_matches_detect_arrays(device):
    """detect_arrays_rows_sharded at 1, 3 and 8 shards on one card ==
    detect_arrays of the whole frame, through the tiles kernels."""
    from feature_detector_fast_tpu_torch.parallel import mesh as meshlib, spatial

    ref = load_luma8(os.path.join(REPO, "media", "Screenshot315_torch_grey.png"))
    for shards in (1, 3, 8):
        mesh = meshlib.make_mesh(devices=[device] * shards)
        for mode in NonmaxMode:
            before = fast_cuda.LAUNCHES["words_tiles"]
            xy = spatial.detect_arrays_rows_sharded(ref, 16, 9, mode, mesh=mesh)
            assert fast_cuda.LAUNCHES["words_tiles"] == before + 1  # one device, one launch
            np.testing.assert_array_equal(xy, port.detect_arrays(ref, Config(16, 9, mode)))
            mask, score = spatial.detect_rows_sharded(ref, 16, 9, mode, mesh=mesh)
            k_mask, k_score = fast_cuda.detect_dense(torch.from_numpy(ref)[None].to(device), 16, 9, mode)
            assert torch.equal(mask, k_mask[0].bool()) and torch.equal(score, k_score[0])


#: The OFF-floor strip kernels' edges: 8-row strips (one 1080p frame, two
#: of 1037 x 1931, small batches), 32-row strips (5 and 8 frames of 1080p:
#: enough strips to fill the card), frames lower than the circle or
#: narrower than a strip, and 130 x 131, whose last plane tile has its high
#: field past the frame.
STRIP_EDGE_SHAPES = [(2, 300, 157), (1, 61, 33), (3, 8, 64), (1, 1080, 1920), (1, 7, 9),
                     (1, 5, 200), (1, 130, 131), (2, 1037, 1931)]


@pytest.mark.parametrize("stage", ["load", "triple", "prefilter"])
def test_off_floor_matches_plain(device, stage):
    """Each OFF floor stage == its plain version on the card (TRIPLE at span
    128 and 8, PREFILTER at need 2 and 3), one launch per call, on the strip
    kernels' edges and a batch of 5 1080p frames (32-row strips)."""
    from feature_detector_fast_tpu_torch.ops import exp_off, exp_off_cuda

    rng = np.random.default_rng(13)
    cases = {"load": [()], "triple": [(128,), (8,)], "prefilter": [(16, 9), (16, 12)]}[stage]
    for shape in STRIP_EDGE_SHAPES + [(5, 1080, 1920)]:
        imgs = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(device)
        for args in cases:
            before = exp_off_cuda.LAUNCHES[f"floor_{stage}"]
            got = exp_off_cuda.FLOORS[stage](imgs, *args)
            torch.cuda.synchronize()
            assert exp_off_cuda.LAUNCHES[f"floor_{stage}"] == before + 1
            want = exp_off.FLOORS[stage](imgs, *args)
            assert torch.equal(got, want), (shape, args)


def test_words_prepacked_matches_words_kernel(device):
    """The prepacked words kernel == fdf_fast_words OFF and == its plain
    version, counts 9..=16, t 0, 16 and 32, on the strip kernels' edges and
    8 frames of 1080p (32-row strips), and on planes it stages element by
    element: a pitch of 131 (not a multiple of 4) and a base 4 bytes past a
    16-byte boundary."""
    from feature_detector_fast_tpu_torch.ops import exp_off, exp_off_cuda

    rng = np.random.default_rng(14)
    cases = []
    for shape in STRIP_EDGE_SHAPES + [(8, 1080, 1920)]:
        imgs = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(device)
        cases.append((shape, imgs, exp_off.prepack(imgs)))
    imgs = torch.from_numpy(rng.integers(0, 256, (1, 1037, 131), np.uint8)).to(device)
    cases.append(("pitch 131", imgs, exp_off.prepack(imgs)[..., :131].contiguous()))
    imgs, plane = cases[-2][1], cases[-2][2]
    shifted = torch.empty(plane.numel() + 1, dtype=torch.int32, device=device)[1:]
    shifted = shifted.view(plane.shape).copy_(plane)
    assert shifted.data_ptr() % 16 == 4
    cases.append(("base 4 B past 16", imgs, shifted))
    for what, imgs, plane in cases:
        _, h, w = imgs.shape
        for count in range(9, 17):
            for t in (0, 16, 32):
                before = exp_off_cuda.LAUNCHES["words_prepacked"]
                got = exp_off_cuda.words_prepacked(plane, t, count, height=h, width=w)
                torch.cuda.synchronize()
                assert exp_off_cuda.LAUNCHES["words_prepacked"] == before + 1
                assert torch.equal(got, fast_cuda.detect_words(imgs, t, count, NonmaxMode.OFF)), \
                    (what, count, t)
                assert torch.equal(got, exp_off.words_prepacked(plane, t, count, height=h,
                                                                width=w)), (what, count, t)


@pytest.mark.parametrize("name", ["pred16", "pred8"])
def test_swar_pred_matches_plain(device, name):
    """The predicate-sequence kernels == their plain versions on int32
    planes over the whole range (wrapping adds) and the tool's [0, 2^30)."""
    from feature_detector_fast_tpu_torch.ops import exp_off, exp_off_cuda

    rng = np.random.default_rng(15)
    for low, high in ((-2**31, 2**31), (0, 2**30)):
        x, a, b = (torch.from_numpy(rng.integers(low, high, (1000, 128), np.int64)
                                    .astype(np.int32)).to(device) for _ in range(3))
        before = exp_off_cuda.LAUNCHES[name]
        got = getattr(exp_off_cuda, f"swar_{name}")(x, a, b)
        torch.cuda.synchronize()
        assert exp_off_cuda.LAUNCHES[name] == before + 1
        assert torch.equal(got, getattr(exp_off, f"swar_{name}")(x, a, b))
