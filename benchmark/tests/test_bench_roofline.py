"""The frozen roofline arithmetic, held to hand counts on small frames."""

import numpy as np
import torch

from benchmark.reference import fast as ref_fast
from benchmark.yardstick import roofline


def _frame_with_one_corner():
    """A 9x9 black frame with one pixel of 200 at (4, 4): the detectable
    pixels are (3..5, 3..5), and the centre is a corner (every tap is 200
    darker)."""
    f = np.zeros((9, 9), np.uint8)
    f[4, 4] = 200
    return torch.from_numpy(f)


def test_work_counts_by_hand():
    frame = _frame_with_one_corner()
    work = roofline.fast_work(frame[None], threshold=16, count=9)
    # Detectable pixels: x, y in [3, 5] -> 3 x 3.
    assert work["pixels"] == 9
    # The centre sees all four cardinal taps darker: it passes the prefilter
    # and the arc test.  Its neighbours at distance 1 see the bright pixel
    # inside their circle only (radius 3 holds no distance-1 tap), so their
    # taps all equal them: no candidate.
    assert work["candidates"] == 1
    assert work["corners"] == 1


def test_bound_by_hand():
    frame = _frame_with_one_corner()
    work = roofline.fast_work(frame[None], 16, 9)
    b = roofline.fast_words_bound(1, 9, 9, "max_threshold", 9, work)
    ops = 9 * 17 + 1 * (48 - 8) + 1 * (9 + 16 + 64 + 16 + 3)
    assert b["int_ops"] == ops
    assert b["bytes"] == 81 + 9 * 1 * 4  # the pixels in, one word a row out
    assert b["bound_s"] == max(b["bytes"] / 3.35e12, ops / (64 * 132 * 1.98e9))
    assert b["bound_by"] == "bytes"  # 117 bytes outweigh 301 operations


def test_score_ops():
    assert roofline.fast_score_ops("max_threshold", 9) == 99
    assert roofline.fast_score_ops("max_threshold", 12) == 131
    assert roofline.fast_score_ops("sum_absolute", 9) == 65
    assert roofline.fast_score_ops("off", 9) == 0


def test_work_matches_the_plain_detector_on_the_golden_frame():
    from benchmark.data import frames

    f = torch.from_numpy(frames.golden()[:64, :96].copy())
    work = roofline.fast_work(f[None], 16, 9)
    assert work["pixels"] == 58 * 90
    assert work["corners"] == int(ref_fast.corner_mask(f, 16, 9).sum())
    assert work["corners"] <= work["candidates"] <= work["pixels"]


def test_the_copy_agrees_with_the_ports_tools_on_a_crop():
    """The frozen copy gives the bound the port's own tools gave when it was
    copied (``tools/_common.fast_bound``)."""
    from benchmark.data import frames
    from feature_detector_fast_tpu_torch.tools import _common

    f = torch.from_numpy(frames.golden()[200:264, 300:460].copy())[None]
    ours = roofline.fast_words_bound(1, 64, 160, "max_threshold", 9,
                                     roofline.fast_work(f, 16, 9))
    theirs = _common.fast_bound(1, 64, 160, "max_threshold", 9, _common.fast_work(f, 16, 9),
                                words=True)
    assert ours["int_ops"] == theirs["int_ops"]
    assert ours["bytes"] == theirs["bytes"]
    np.testing.assert_allclose(ours["bound_s"] * 1e3, theirs["bound_ms"], rtol=1e-12)
