"""What the detection drivers share: the frame pool, the prepared batches,
the comparison with the plain detector, and the control.

A request detects one batch: the ``batches`` prepared batches (seeded
permutations of the ``pool`` frames) are cycled, so the timed loop makes no
inputs of its own.  The answers kept from the window are held, frame by
frame, to ``reference.fast``'s row-major keypoint lists of the pool: the
number compared is the count of keypoints that differ (limit 0).
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.data import frames as frames_lib
from benchmark.reference import fast as ref_fast
from benchmark.yardstick import roofline


class FastBatches:
    """Set-up, requests and the comparison of one detection cell; the
    subclass says how a batch reaches the program and what comes back."""

    resident = False

    def __init__(self, config: Dict, traffic: Dict, seed: int, device: torch.device,
                 limits: Dict[str, float]):
        from feature_detector_fast_tpu_torch import api
        from feature_detector_fast_tpu_torch.config import Config, NonmaxMode

        self.api = api
        self.device = device
        self.limits = limits
        self.threshold, self.count = int(config["threshold"]), int(config["count"])
        self.mode = config["nonmax"]
        self.program_config = Config(threshold=self.threshold, count=self.count,
                                     nonmax=NonmaxMode(self.mode))
        self.height, self.width = int(config["height"]), int(config["width"])
        self.batch = int(traffic["batch"])
        self.pool = frames_lib.pool(seed, int(traffic["pool"]), self.height, self.width)
        self.perms = frames_lib.permutations(seed, int(traffic["batches"]), len(self.pool),
                                             self.batch)
        host = [np.ascontiguousarray(self.pool[p]) for p in self.perms]
        self.batches = ([torch.from_numpy(b).to(device) for b in host] if self.resident
                        else host)
        self.frames_per_request = self.batch
        self._next = 0
        self._work: Optional[dict] = None
        for _ in self.batches:  # every prepared batch once: the kernel builds, the allocator fills
            self.request()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _take(self) -> int:
        b = self._next % len(self.batches)
        self._next += 1
        return b

    def request(self):
        raise NotImplementedError

    def lists(self, answer) -> List[np.ndarray]:
        """The per-frame keypoint lists an answer holds."""
        raise NotImplementedError

    def counts(self, answer) -> Optional[np.ndarray]:
        """The per-frame counts an answer states apart from its lists."""
        return None

    def release(self) -> None:
        self.batches = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def roofline_work(self) -> Tuple[dict, dict]:
        """(what one batch is, its ``roofline.fast_work``): every batch is a
        permutation of the pool, so the pool's work is each batch's."""
        if self._work is None:
            frames = torch.from_numpy(self.pool[self.perms[0]]).to(self.device)
            self._work = roofline.fast_work(frames, self.threshold, self.count)
        shape = dict(frames=self.batch, height=self.height, width=self.width, mode=self.mode,
                     count=self.count)
        return shape, self._work

    def reference(self) -> List[np.ndarray]:
        return [ref_fast.keypoints(torch.from_numpy(f).to(self.device), self.threshold,
                                   self.count, self.mode) for f in self.pool]

    def check(self, kept) -> Tuple[List[Tuple[str, float, float]], int]:
        ref = self.reference()
        mismatched = count_errors = failed = 0
        for _, answer in kept:
            b = answer[0]
            bad = 0
            for frame, got in zip(self.perms[b], self.lists(answer)):
                bad += ref_fast.list_mismatch(got, ref[frame])
            counts = self.counts(answer)
            if counts is not None:
                want = np.array([len(ref[f]) for f in self.perms[b]])
                count_errors += int((np.asarray(counts) != want).sum())
            mismatched += bad
            failed += int(bad > 0)
        numbers = [("keypoints_mismatched", mismatched, self.limits["keypoints_mismatched"])]
        if self.resident:
            numbers.append(("counts_mismatched", count_errors, self.limits["counts_mismatched"]))
        frames = sum(len(self.perms[a[0]]) for _, a in kept)
        print(f"checked {len(kept)} batches ({frames} frames) against the plain detector",
              file=sys.stderr)
        return numbers, failed

    def controls(self):
        """The controls by name, each a context manager under which requests
        give the control's answers: ``nonstrict``, the plain detector with
        the arc test's comparisons made non-strict (>= t) in the program's
        place, which breaks the configuration's OpenCV 3.2 parity."""
        return {"nonstrict": self._nonstrict}

    @contextlib.contextmanager
    def _nonstrict(self):
        program = self.request

        def request():
            b = self._take()
            lists = [ref_fast.keypoints(torch.from_numpy(self.pool[f]).to(self.device),
                                        self.threshold, self.count, self.mode, strict=False)
                     for f in self.perms[b]]
            return self.as_answer(b, lists)

        self.request = request
        try:
            yield
        finally:
            self.request = program

    def as_answer(self, b: int, lists: List[np.ndarray]):
        raise NotImplementedError
