"""Device meshes for the multi-device front-end.

Counterpart of ``feature_detector_fast_tpu.parallel.mesh``.  Axis
conventions, as in the JAX package:

  * ``data``  -- frames, or the row shards of one frame
  * ``model`` -- landmark / camera blocks inside bundle adjustment

A :class:`Mesh` is a grid of explicit ``torch.device``s that one process
drives, as ``shard_map`` drives a JAX mesh: every shard's work is enqueued
from this process on its own device, and data moves between devices by
copies ordered on the current CUDA streams.  A device may appear more than
once: n shards then share one card (or the CPU in the tests, the
counterpart of the JAX tests' spoofed 8-device CPU mesh), and the callers
launch one kernel per run of consecutive shards on one device, not one per
shard.

``torch.distributed`` (one process per GPU, NCCL) is not used here: NCCL
puts no two ranks on one GPU, so on a one-card machine no shard seam would
ever meet the kernel.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """An n-dimensional grid of ``torch.device``s with named axes."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device grid needs {devices.ndim} axis "
                             f"names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """Size of each named axis, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def devices_along(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if j == i else 0 for j in range(self.devices.ndim))
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def cuda_devices() -> List[torch.device]:
    """Every visible CUDA device; raises if there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices=[torch.device('cpu')] * n "
                           "for the plain PyTorch path")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:  # "cuda" names the current card
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_grid(devices: Sequence) -> np.ndarray:
    """A 1-D object array of ``torch.device``s (numpy would unpack tuples)."""
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [_device(d) for d in devices]
    return grid


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh.

    ``devices`` defaults to every visible CUDA device (and raises without
    CUDA: the mesh never falls back to the CPU); it may repeat a device.
    ``n_data`` defaults to all of them on the data axis."""
    devs = list(devices) if devices is not None else cuda_devices()
    if n_data is None:
        n_data = len(devs) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devs):
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, "
                         f"have {len(devs)}")
    grid = device_grid(devs[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def device_runs(devices: Sequence[torch.device]) -> List[Tuple[torch.device, int, int]]:
    """Split a list of shard devices into maximal runs of consecutive
    shards on one device: (device, first shard, number of shards)."""
    runs: List[Tuple[torch.device, int, int]] = []
    for i, dev in enumerate(devices):
        if runs and runs[-1][0] == dev:
            runs[-1] = (dev, runs[-1][1], runs[-1][2] + 1)
        else:
            runs.append((dev, i, 1))
    return runs
