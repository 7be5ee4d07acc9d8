"""Row-sharded detection of one frame over the mesh's data devices.

Counterpart of ``feature_detector_fast_tpu.parallel.spatial``.  The frame's
rows are split into S shards of ``rows`` rows each (the frame padded with
zero rows to S * rows; ``rows`` a multiple of the kernel's 8-row block, so
no shard is shorter than its halo).  Every shard takes ``HALO`` = 4 rows of
each neighbour -- circle radius 3 plus the nonmax ring -- and the row-shard
kernels (``ops/fast_cuda.detect_dense_tiles`` / ``detect_words_tiles``)
judge every border rule in global rows, so the stitched result equals the
whole-frame detector bit for bit.

One process drives every shard (see ``parallel/mesh.py``).  The halo
exchange, two ``ppermute``s in the JAX package, is a ring of copies of
4-row slabs to the neighbouring shard's device (``.to(dev,
non_blocking=True)``, ordered by the current streams); as there, the
global top and bottom shards get the wrapped rows of the other end, which
the kernels mask.  Consecutive shards on one device form one slab stack by
one gather of their rows and launch one kernel per device, whatever the
shard count.

The keypoint list needs no superword cap, no per-shard cap and no retry:
each run of shards decodes its words on its own device
(``ops/compact.words_to_points``), shard s's rows are offset by s * rows,
and the lists joined in shard order are in global row-major order.  The
words kernel has no width limit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import NonmaxMode
from ..ops import compact, fast_cuda
from . import mesh as meshlib

#: Rows each shard takes from each neighbour (circle radius + nonmax ring).
HALO = fast_cuda.MIN_HALO
#: Shard heights are multiples of the kernel's 8-row block.
ROW_TILE = 8


def shard_rows(h: int, n: int) -> int:
    """Rows per shard of an ``h``-row frame over ``n`` shards."""
    per_shard = -(-h // n)
    return -(-per_shard // ROW_TILE) * ROW_TILE


def _frame(image) -> torch.Tensor:
    img = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.asarray(image))
    if img.dtype != torch.uint8 or img.dim() != 2 or min(img.shape) < 1:
        raise ValueError(f"expected a non-empty (H, W) uint8 frame, got {img.dtype} "
                         f"{tuple(img.shape)}")
    return img


def shard_slabs(image: torch.Tensor, devices, rows: int):
    """Cut an (H, W) frame into len(devices) row shards of ``rows`` rows
    with their halos.  Per run of consecutive shards on one device:
    ((device, first shard, shards), ext (shards, rows + 2*HALO, W) u8 and
    row0 (shards,) int32 on that device)."""
    h, w = image.shape
    n = len(devices)
    padded = F.pad(image, (0, 0, 0, n * rows - h))
    runs = meshlib.device_runs(devices)
    blocks = [padded[a * rows:(a + m) * rows].to(dev, non_blocking=True)
              for dev, a, m in runs]
    out = []
    for i, (dev, a, m) in enumerate(runs):
        top = blocks[i - 1][-HALO:].to(dev, non_blocking=True)
        bottom = blocks[(i + 1) % len(runs)][:HALO].to(dev, non_blocking=True)
        local = torch.cat([top, blocks[i], bottom])
        # One gather: shard j's slab is rows [j * rows, j * rows + rows + 2*HALO).
        ext = local.unfold(0, rows + 2 * HALO, rows).transpose(1, 2).contiguous()
        row0 = torch.arange(a, a + m, dtype=torch.int32, device=dev) * rows
        out.append(((dev, a, m), ext, row0))
    return out


def detect_rows_sharded(image, threshold: int, count: int, nonmax: NonmaxMode, *,
                        mesh: meshlib.Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-frame detection with rows sharded over the mesh's data axis.

    Returns (mask bool (H, W), score u16 (H, W)) on the mesh's first data
    device, bit-identical to ``ops.fast.detect_dense`` of the whole frame."""
    img = _frame(image)
    h, w = img.shape
    devices = mesh.devices_along(meshlib.DATA_AXIS)
    rows = shard_rows(h, len(devices))
    masks, scores = [], []
    for _, ext, row0 in shard_slabs(img, devices, rows):
        mask, score = fast_cuda.detect_dense_tiles(
            ext, row0, threshold, count, nonmax, height=h, width=w, halo=HALO)
        masks.append(mask.reshape(-1, w).to(devices[0], non_blocking=True))
        scores.append(score.reshape(-1, w).to(devices[0], non_blocking=True))
    return torch.cat(masks)[:h].to(torch.bool), torch.cat(scores)[:h]


def detect_compact_rows_sharded(image, threshold: int, count: int, nonmax: NonmaxMode, *,
                                mesh: meshlib.Mesh) -> List[torch.Tensor]:
    """Row-sharded detection ending in the keypoint list: each run of
    shards on one device runs the words kernel on its rows (no dense mask
    exists) and decodes its own words there.

    Returns one (N_r, 2) int32 tensor of (x, y) rows per run of shards on
    one device, on that device; joined in order they are the frame's
    keypoints in row-major order."""
    img = _frame(image)
    h, w = img.shape
    devices = mesh.devices_along(meshlib.DATA_AXIS)
    rows = shard_rows(h, len(devices))
    out = []
    for (_, first, _), ext, row0 in shard_slabs(img, devices, rows):
        words = fast_cuda.detect_words_tiles(
            ext, row0, threshold, count, nonmax, height=h, width=w, halo=HALO)
        pts = compact.words_to_points(words)  # (shard in run, own row, x), ascending
        y = (first + pts[:, 0]) * rows + pts[:, 1]
        out.append(torch.stack([pts[:, 2], y], dim=1).to(torch.int32))
    return out


def detect_arrays_rows_sharded(image, threshold: int = 16, count: int = 9,
                               nonmax: NonmaxMode = NonmaxMode.OFF, *,
                               mesh: meshlib.Mesh) -> np.ndarray:
    """Row-sharded ``api.detect_arrays``: (N, 2) uint32 (x, y) keypoints in
    row-major order, bit-identical to the single-device API.  No keypoint
    is ever dropped: there is no cap to overflow."""
    parts = detect_compact_rows_sharded(image, threshold, count, nonmax, mesh=mesh)
    return np.concatenate([p.cpu().numpy() for p in parts]).view(np.uint32)
