"""The CUDA kernel on the card: marked ``cuda``, skipped where there is none.

Run them on a machine with an NVIDIA GPU (which need not have JAX, so the
JAX-side conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Kernel and plain version agree exactly (integer outputs: tolerance zero).
"""

import os

import numpy as np
import pytest
import torch

import feature_detector_fast_tpu_torch as port
from feature_detector_fast_tpu_torch.config import Config, NonmaxMode
from feature_detector_fast_tpu_torch.ops import compact, fast, fast_cuda
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
            assert fast_cuda.LAUNCHES == {k: v + 1 for k, v in before.items()}
            assert torch.equal(words, compact.pack_mask_words(mask))
            assert torch.equal(k_mask.to(torch.int32), mask.to(torch.int32))
            assert torch.equal(k_score.to(torch.int32), score.to(torch.int32))


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
