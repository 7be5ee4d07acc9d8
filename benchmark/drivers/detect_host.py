"""Detection of host batches through the main API: each request hands a
(B, H, W) u8 numpy batch to ``api.detect_batch_arrays`` and ends with the
per-frame row-major keypoint lists on the host.  The host-to-device copy,
the FAST words kernel, compaction, decode and split all lie on its path."""

from __future__ import annotations

from benchmark.drivers.fast_common import FastBatches


class HostBatches(FastBatches):
    resident = False

    def request(self):
        b = self._take()
        return b, self.api.detect_batch_arrays(self.batches[b], self.program_config,
                                               device=self.device)

    def lists(self, answer):
        return answer[1]

    def as_answer(self, b, lists):
        return b, lists


def make(config, traffic, seed, device, limits):
    return HostBatches(config, traffic, seed, device, limits)
