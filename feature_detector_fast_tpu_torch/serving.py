"""Pipelined detection serving.

Counterpart of ``feature_detector_fast_tpu.serving``.  Frames stream
through in (B, H, W) u8 batches.  On CUDA each submitted batch is staged in
pinned host memory and enqueued on a side stream -- a non-blocking copy to
the device and the FAST words kernel -- closed by an event.  Up to
``depth`` batches stay in flight, so the copies and kernels of later
batches overlap the decode of earlier ones.  A finished batch is decoded
into per-frame keypoint lists on the device, on the caller's stream after
it waits for the batch's event, and only the lists cross to the host.

    pipe = DetectorPipeline(Config(16, 9, NonmaxMode.MAX_THRESHOLD))
    for batch in frame_batches:          # (B, H, W) uint8 each
        pipe.submit(batch)
        for kps in pipe.ready():         # completed earlier batches
            ...
    for kps in pipe.drain():             # flush the tail
        ...
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .api import _device
from .config import Config
from .ops import compact, fast_cuda


class DetectorPipeline:
    """Keeps up to ``depth`` batches in flight on the device."""

    def __init__(self, config: Optional[Config] = None, *, depth: int = 2,
                 device="cuda"):
        self.config = config or Config()
        self.depth = int(depth)
        self.device = _device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # (event or None, words, the staged batch the queued copy still reads)
        self._inflight: Deque[Tuple[Optional[torch.cuda.Event], torch.Tensor,
                                    Optional[torch.Tensor]]] = deque()

    def _detect(self, images: torch.Tensor) -> torch.Tensor:
        c = self.config
        return fast_cuda.detect_words(images, c.threshold, c.count, c.nonmax)

    def submit(self, batch: np.ndarray) -> None:
        """Enqueue a (B, H, W) uint8 batch (non-blocking on CUDA)."""
        batch = np.asarray(batch)
        if batch.ndim != 3 or batch.dtype != np.uint8:
            raise ValueError("expected a (B, H, W) uint8 batch")
        if self._stream is None:
            words = self._detect(torch.from_numpy(np.ascontiguousarray(batch)))
            self._inflight.append((None, words, None))
            return
        staged = torch.empty(batch.shape, dtype=torch.uint8, pin_memory=True)
        staged.numpy()[...] = batch
        # The side stream must not start before work already queued on the
        # caller's stream (e.g. frames it produced).
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            words = self._detect(staged.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        self._inflight.append((event, words, staged))

    def _decode(self, entry) -> List[np.ndarray]:
        event, words, _ = entry
        if event is not None:
            # Decode on the caller's stream once the batch is done; the
            # decode ends in host copies, so `words` (allocated on the side
            # stream) has no pending use when it is released.
            torch.cuda.current_stream(self.device).wait_event(event)
        return compact.split_frames(compact.words_to_points(words), words.shape[0])

    def ready(self) -> Iterator[List[np.ndarray]]:
        """Yield per-frame keypoint lists of batches beyond the pipeline
        depth (blocks only on the oldest batch)."""
        while len(self._inflight) > self.depth:
            yield self._decode(self._inflight.popleft())

    def drain(self) -> Iterator[List[np.ndarray]]:
        """Flush all remaining in-flight batches."""
        while self._inflight:
            yield self._decode(self._inflight.popleft())
