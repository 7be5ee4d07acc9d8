"""Data-parallel front-end: batched FAST detection over a device mesh.

Counterpart of ``feature_detector_fast_tpu.parallel.frontend``.  The frames
of a batch are split over the mesh's data devices; each device runs the
dense FAST kernel (``ops/fast_cuda.detect_dense``) on its frames, one
launch per run of consecutive shards on that device.  Outputs stay on the
device that produced them, so per-frame stages downstream (descriptors,
matching) stay local to it; :func:`gather` joins them where a caller needs
one batch.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import NonmaxMode
from ..ops import fast_cuda
from . import mesh as meshlib

Shard = Tuple[torch.Tensor, torch.Tensor]


def detect_batch(images: torch.Tensor, threshold: int, count: int,
                 nonmax: NonmaxMode) -> Shard:
    """Dense detection over a (B, H, W) u8 batch on its device:
    (mask bool, score u16), both (B, H, W)."""
    mask, score = fast_cuda.detect_dense(images, threshold, count, nonmax)
    return mask.to(torch.bool), score


def detect_batch_sharded(images, threshold: int, count: int, nonmax: NonmaxMode, *,
                         mesh: meshlib.Mesh) -> List[Shard]:
    """Batched detection with the batch dimension split over ``data``.

    ``images`` is a (B, H, W) u8 numpy array or tensor.  Shard i takes the
    i-th of len(devices) consecutive slices of the batch (the first
    B % len(devices) one frame longer).  Returns one (mask, score) per
    shard, on the shard's device; shards on one device are views of one
    launch's outputs."""
    imgs = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.asarray(images))
    if imgs.dim() != 3:
        raise ValueError(f"expected a (B, H, W) batch, got shape {tuple(imgs.shape)}")
    devices = mesh.devices_along(meshlib.DATA_AXIS)
    b, n = imgs.shape[0], len(devices)
    start = np.concatenate([[0], np.cumsum([b // n + (i < b % n) for i in range(n)])])
    out: List[Shard] = []
    for dev, first, m in meshlib.device_runs(devices):
        lo = int(start[first])
        local = imgs[lo:int(start[first + m])].to(dev, non_blocking=True).contiguous()
        mask, score = detect_batch(local, threshold, count, nonmax)
        for i in range(first, first + m):
            sl = slice(int(start[i]) - lo, int(start[i + 1]) - lo)
            out.append((mask[sl], score[sl]))
    return out


def gather(shards: Sequence[Shard], device) -> Shard:
    """Join per-shard (mask, score) outputs into one batch on ``device``."""
    return tuple(torch.cat([s[j].to(device, non_blocking=True) for s in shards])
                 for j in range(2))
