"""The port's meshes and data-parallel front-end on the CPU, against the JAX
package (as tests/test_parallel.py holds the JAX side).

A mesh here is a list of repeated CPU devices; outputs are integers, so
every comparison is exact.
"""

import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.config import NonmaxMode as JaxNonmaxMode
from feature_detector_fast_tpu.ops import fast as jax_fast
from feature_detector_fast_tpu_torch.config import NonmaxMode
from feature_detector_fast_tpu_torch.ops import fast_cuda
from feature_detector_fast_tpu_torch.parallel import frontend, mesh as meshlib

CPU = torch.device("cpu")


def test_mesh_needs_cuda_or_devices(monkeypatch):
    """With no CUDA and no devices the mesh raises: it never falls back to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        meshlib.make_mesh()
    mesh = meshlib.make_mesh(devices=[CPU] * 8)
    assert mesh.shape == {meshlib.DATA_AXIS: 8, meshlib.MODEL_AXIS: 1}
    assert mesh.devices_along(meshlib.DATA_AXIS) == [CPU] * 8


def test_mesh_shapes():
    """(data, model) grids as the JAX make_mesh builds them."""
    devs = [torch.device("meta")] * 4 + [CPU] * 4
    mesh = meshlib.make_mesh(n_model=2, devices=devs)
    assert mesh.shape == {meshlib.DATA_AXIS: 4, meshlib.MODEL_AXIS: 2}
    assert mesh.devices_along(meshlib.MODEL_AXIS) == [torch.device("meta")] * 2
    assert mesh.devices_along(meshlib.DATA_AXIS) == [torch.device("meta")] * 2 + [CPU] * 2
    assert meshlib.make_mesh(3, devices=devs).shape[meshlib.DATA_AXIS] == 3
    with pytest.raises(ValueError):
        meshlib.make_mesh(5, 2, devices=devs)


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_sharded_batch_detect_matches_jax(rng, shards):
    """detect_batch_sharded of an (8, 32, 64) batch == JAX ops.fast.detect_dense
    frame by frame; the shards stay per shard until gathered."""
    images = rng.integers(0, 256, (8, 32, 64), np.uint8)
    mode = NonmaxMode.MAX_THRESHOLD
    before = dict(fast_cuda.LAUNCHES)
    out = frontend.detect_batch_sharded(images, 16, 9, mode,
                                        mesh=meshlib.make_mesh(devices=[CPU] * shards))
    assert fast_cuda.LAUNCHES == before
    assert len(out) == shards
    assert sum(m.shape[0] for m, _ in out) == 8
    mask, score = frontend.gather(out, CPU)
    assert mask.dtype == torch.bool and score.dtype == torch.uint16
    for i in range(8):
        j_mask, j_score = jax_fast.detect_dense_jit(images[i], 16, 9, JaxNonmaxMode.MAX_THRESHOLD)
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(j_mask))
        np.testing.assert_array_equal(score[i].numpy(), np.asarray(j_score))


def test_device_runs():
    meta = torch.device("meta")
    assert meshlib.device_runs([CPU] * 3) == [(CPU, 0, 3)]
    assert meshlib.device_runs([CPU, meta, meta, CPU]) == [(CPU, 0, 1), (meta, 1, 2), (CPU, 3, 1)]
    assert meshlib.device_runs([]) == []
