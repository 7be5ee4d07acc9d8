"""Pipeline-parallel front-end over a ``pipe`` mesh axis.

Counterpart of ``feature_detector_fast_tpu.parallel.pipeline``.  Three
stages, one device and one CUDA stream each:

  0. dense FAST detection (SumAbsolute scores) + deterministic top-K
  1. BRIEF-256 description at the keypoint slots (``brief.describe_best``)
  2. mutual-NN / ratio matching of frame i against frame i-1 (the previous
     frame's descriptors stay on stage 2's device)

The schedule is the JAX version's fill/steady/drain: with B frames, B + 2
ticks; at tick t stage 0 takes frame t, stage 1 frame t-1 and stage 2
frame t-2, so from tick 2 on all three stages are busy on their own
streams.  After each tick every activation moves one stage forward: a copy
to the next stage's device issued on the producing stage's stream (so it
starts after its producer), an event the consumer's stream waits for, and
``record_stream`` so the caching allocator does not reuse the memory while
the consumer still reads it.  The image rides only the 0 -> 1 hop.  One
process drives all stages, and nothing on the path synchronises the host
with a device.  On one card the three stages are three streams on it
(``make_pipe_mesh([cuda:0] * 3)``); on the CPU there are no streams.

Results equal the sequential front-end (``brief.detect_and_describe`` +
``match.match`` of each frame against its predecessor) bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import NonmaxMode
from ..models import brief, match as matchlib
from ..models.brief import Keypoints
from ..ops import fast_cuda
from . import mesh as meshlib

PIPE_AXIS = "pipe"
N_STAGES = 3


def make_pipe_mesh(devices=None) -> meshlib.Mesh:
    """1-D mesh of N_STAGES devices along the ``pipe`` axis.  ``devices``
    defaults to every visible CUDA device and may repeat one; all must be
    of one type."""
    devs = list(devices) if devices is not None else meshlib.cuda_devices()
    if len(devs) < N_STAGES:
        raise ValueError(f"pipeline needs {N_STAGES} devices, have {len(devs)}")
    grid = meshlib.device_grid(devs[:N_STAGES])
    if len({d.type for d in grid}) != 1:
        raise ValueError(f"pipeline stages must share a device type, got {list(grid)}")
    return meshlib.Mesh(grid, (PIPE_AXIS,))


class FrontendStream(NamedTuple):
    """Per-frame front-end outputs for a B-frame stream (batch-leading), on
    the last stage's device."""

    kp_xy: torch.Tensor  # (B, K, 2) int32
    kp_score: torch.Tensor  # (B, K) int32
    kp_valid: torch.Tensor  # (B, K) bool
    desc: torch.Tensor  # (B, K, WORDS) int32
    dvalid: torch.Tensor  # (B, K) bool
    match_idx: torch.Tensor  # (B, K) int32: slot of frame i-1 (-1 = unmatched; frame 0 all -1)
    match_dist: torch.Tensor  # (B, K) int32 (BITS + 1 where unmatched)


class _Stage:
    """One stage's device and, on CUDA, its own stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def running(self):
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def send(self, tensors: List[torch.Tensor], dst: "_Stage") -> List[torch.Tensor]:
        """Move this stage's outputs to ``dst``: ordered after the work this
        stage has enqueued, and ahead of what ``dst`` enqueues next."""
        with self.running():
            moved = [t.to(dst.device, non_blocking=True) for t in tensors]
        if self.stream is not None:
            ready = torch.cuda.Event()
            ready.record(self.stream)
            dst.stream.wait_event(ready)
            for t in moved:
                t.record_stream(dst.stream)
        return moved


def frontend_pipelined(frames, threshold: int, count: int, k: int, *,
                       mesh: meshlib.Mesh, oriented: bool = False) -> FrontendStream:
    """Run the 3-stage front-end pipeline over a (B, H, W) u8 frame stream
    (numpy array or tensor).

    Returns per-frame keypoints, descriptors, and matches of each frame
    against its predecessor, bit-identical to the sequential front-end."""
    frames = frames if isinstance(frames, torch.Tensor) else torch.from_numpy(np.asarray(frames))
    if frames.dtype != torch.uint8 or frames.dim() != 3:
        raise ValueError(f"expected a (B, H, W) uint8 stream, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    b = frames.shape[0]
    stages = [_Stage(d) for d in mesh.devices_along(PIPE_AXIS)]
    first, middle, last = stages
    k = int(k)

    out_dev = last.device
    out = FrontendStream(
        kp_xy=torch.empty((b, k, 2), dtype=torch.int32, device=out_dev),
        kp_score=torch.empty((b, k), dtype=torch.int32, device=out_dev),
        kp_valid=torch.empty((b, k), dtype=torch.bool, device=out_dev),
        desc=torch.empty((b, k, brief.WORDS), dtype=torch.int32, device=out_dev),
        dvalid=torch.empty((b, k), dtype=torch.bool, device=out_dev),
        match_idx=torch.empty((b, k), dtype=torch.int32, device=out_dev),
        match_dist=torch.empty((b, k), dtype=torch.int32, device=out_dev),
    )
    for st in stages:
        if st.stream is not None:
            # Work already queued on the caller's streams (the frames, the
            # output buffers' memory) comes first.
            st.stream.wait_stream(torch.cuda.current_stream(st.device))

    def detect(img: torch.Tensor) -> List[torch.Tensor]:
        mask, score = fast_cuda.detect_dense(img[None], threshold, count,
                                             NonmaxMode.SUM_ABSOLUTE)
        kps = brief.select_topk(mask, score, k)
        return [img, kps.xy[0], kps.score[0], kps.valid[0]]

    def describe(img, xy, score, valid) -> List[torch.Tensor]:
        kps = Keypoints(xy[None], score[None], valid[None])
        desc, dvalid = brief.describe_best(img[None], kps, oriented)
        return [xy, score, valid, desc[0], dvalid[0]]

    prev: Optional[List[torch.Tensor]] = None  # stage 2's state: frame i-1's (desc, dvalid)
    inbox1 = inbox2 = None
    for tick in range(b + N_STAGES - 1):
        out0 = out1 = None
        if tick < b:
            with first.running():
                out0 = detect(frames[tick].to(first.device, non_blocking=True))
        if inbox1 is not None:
            with middle.running():
                out1 = describe(*inbox1)
        if inbox2 is not None:
            i = tick - 2
            xy, score, valid, desc, dvalid = inbox2
            with last.running():
                if prev is None:  # frame 0 has no predecessor
                    out.match_idx[i].fill_(-1)
                    out.match_dist[i].fill_(brief.BITS + 1)
                else:
                    m = matchlib.match(desc, dvalid, *prev)
                    out.match_idx[i].copy_(m.idx_b)
                    out.match_dist[i].copy_(m.dist)
                for buf, val in zip(out[:5], inbox2):
                    buf[i].copy_(val)
            prev = [desc, dvalid]
        inbox2 = middle.send(out1, last) if out1 is not None else None
        inbox1 = first.send(out0, middle) if out0 is not None else None

    for st in stages:
        if st.stream is not None:
            torch.cuda.current_stream(st.device).wait_stream(st.stream)
    return out
