"""Detection of batches already on the device: each request calls
``api.detect_batch_device`` on a resident (B, H, W) u8 batch and reads the
per-frame counts on the host, as a consumer sizing its next stage would.
The host-to-device copy is bypassed; the FAST words kernel and the count
are the path.  The returned words are decoded by the benchmark itself, after
the window."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.drivers.fast_common import FastBatches
from benchmark.reference import fast as ref_fast


class ResidentBatches(FastBatches):
    resident = True

    def request(self):
        b = self._take()
        words, n = self.api.detect_batch_device(self.batches[b], self.program_config,
                                                device=self.device)
        return b, words, n.cpu().numpy()

    def lists(self, answer):
        return ref_fast.words_to_lists(answer[1])

    def counts(self, answer):
        return answer[2]

    def as_answer(self, b, lists):
        words = torch.stack([torch.as_tensor(pack(l, self.height, self.width))
                             for l in lists]).to(self.device)
        return b, words, np.array([len(l) for l in lists])


def pack(xy: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, ceil(W/32)) int32 words of one frame's (N, 2) (x, y) keypoints."""
    nw = -(-width // 32)
    words = np.zeros((height, nw), np.uint32)
    xy = np.asarray(xy, np.int64).reshape(-1, 2)
    np.bitwise_or.at(words, (xy[:, 1], xy[:, 0] // 32),
                     (np.uint32(1) << (xy[:, 0] % 32).astype(np.uint32)))
    return words.view(np.int32)


def make(config, traffic, seed, device, limits):
    return ResidentBatches(config, traffic, seed, device, limits)
