"""The port's checkpoint module against the JAX package's (Orbax there).

Mirrors tests/test_io_utils.py's round trip: the same state goes through
``feature_detector_fast_tpu.utils.checkpoint`` and the port's
``utils.checkpoint`` into separate directories, and both restores give the
same values, dtypes and shapes; ``latest_step`` of both packages agrees on
one directory.  Then what is the port's own: tensor templates, dtypes
``torch.load(weights_only=True)`` must carry, the atomic save and the
overwrite of an existing step.
"""

import os

import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.utils import checkpoint as jckpt
from feature_detector_fast_tpu_torch.utils import checkpoint


def state_of(rng):
    return {
        "poses": rng.normal(0, 1, (4, 4, 4)).astype(np.float32),
        "points": rng.normal(0, 1, (10, 3)).astype(np.float32),
        "frame": np.int32(7),
    }


def test_roundtrip_matches_jax(tmp_path, rng):
    state = state_of(rng)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    for step in (3, 7):
        jckpt.save_state(jd, step, state)
        checkpoint.save_state(td, step, state)
    assert checkpoint.latest_step(td) == jckpt.latest_step(jd) == 7
    want = jckpt.restore_state(jd, template=jckpt._arrayify(state))
    got = checkpoint.restore_state(td, template=checkpoint._arrayify(state))
    as_np = checkpoint.restore_state(td, template=state)
    assert set(got) == set(want) == set(as_np)
    for k, w in want.items():
        w = np.asarray(w)
        assert isinstance(got[k], torch.Tensor) and isinstance(as_np[k], np.ndarray)
        for g in (got[k].numpy(), as_np[k]):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got["poses"].numpy(), state["poses"])
    assert int(got["frame"]) == 7
    assert checkpoint.restore_state(str(tmp_path / "none")) is None
    assert jckpt.restore_state(str(tmp_path / "none")) is None


def test_latest_step_matches_jax(tmp_path):
    d = tmp_path / "steps"
    assert checkpoint.latest_step(str(d)) is None and jckpt.latest_step(str(d)) is None
    d.mkdir()
    assert checkpoint.latest_step(str(d)) is None and jckpt.latest_step(str(d)) is None
    for name in ("step_3", "step_7", "step_x"):
        (d / name).mkdir()
    (d / "notes.txt").write_text("stray")
    assert checkpoint.latest_step(str(d)) == jckpt.latest_step(str(d)) == 7


def test_restore_without_template_gives_cpu_tensors(tmp_path, rng):
    state = {"a": rng.normal(0, 1, (3,)), "nested": [np.uint8(4), (2.5, True)]}
    checkpoint.save_state(str(tmp_path), 0, state)
    got = checkpoint.restore_state(str(tmp_path))
    assert torch.equal(got["a"], torch.from_numpy(state["a"]))
    n = got["nested"]
    assert isinstance(n, list) and isinstance(n[1], tuple)
    assert n[0].dtype == torch.uint8 and n[0].shape == () and int(n[0]) == 4
    assert n[1][0].dtype == torch.float64 and float(n[1][0]) == 2.5
    assert n[1][1].dtype == torch.bool and bool(n[1][1])


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.bool_, np.int64, np.int8,
                                   np.float16, np.float64])
def test_dtypes_roundtrip(tmp_path, rng, dtype):
    arr = rng.integers(0, 200, (3, 5)).astype(dtype)
    # a non-contiguous view and a scalar of the dtype ride along
    state = {"arr": arr, "view": arr[:, ::2], "scalar": arr.reshape(-1)[3]}
    checkpoint.save_state(str(tmp_path), 1, state)
    back = checkpoint.restore_state(str(tmp_path), template=state)
    tensors = checkpoint.restore_state(str(tmp_path))
    for k, v in state.items():
        v = np.asarray(v)
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)
        np.testing.assert_array_equal(tensors[k].numpy(), v)


def test_tensor_template_takes_dtype_shape_and_device(tmp_path, rng):
    state = {"w": rng.normal(0, 1, (2, 3)).astype(np.float32), "n": np.int32(5),
             "t": torch.arange(6, dtype=torch.int16).reshape(2, 3)}
    checkpoint.save_state(str(tmp_path), 2, state)
    template = {"w": torch.zeros((2, 3), dtype=torch.float64),
                "n": torch.zeros((), dtype=torch.int64),
                "t": np.zeros((2, 3), np.int16)}
    got = checkpoint.restore_state(str(tmp_path), template=template)
    assert got["w"].dtype == torch.float64 and got["w"].device.type == "cpu"
    np.testing.assert_array_equal(got["w"].numpy(), state["w"].astype(np.float64))
    assert got["n"].dtype == torch.int64 and int(got["n"]) == 5
    assert isinstance(got["t"], np.ndarray) and got["t"].dtype == np.int16
    np.testing.assert_array_equal(got["t"], state["t"].numpy())
    with pytest.raises(ValueError, match=r"state\['w'\]"):
        checkpoint.restore_state(str(tmp_path), template={**template, "w": torch.zeros(3, 2)})


def test_save_is_atomic_and_overwrites(tmp_path, monkeypatch):
    d = str(tmp_path)
    checkpoint.save_state(d, 3, {"x": np.ones(4, np.float32)})
    checkpoint.save_state(d, 3, {"x": np.full(4, 2, np.float32)})  # force=True semantics
    assert checkpoint.restore_state(d, 3)["x"].tolist() == [2.0] * 4

    real_save = torch.save

    def preempted(obj, f, *a, **kw):
        real_save(obj, f, *a, **kw)
        f.flush()
        raise KeyboardInterrupt("preempted mid-save")

    monkeypatch.setattr(torch, "save", preempted)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_state(d, 9, {"x": np.zeros(4, np.float32)})
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_state(d, 3, {"x": np.zeros(4, np.float32)})
    monkeypatch.undo()
    assert sorted(os.listdir(d)) == ["step_3"]  # no half-written step, no temp file
    assert checkpoint.latest_step(d) == 3
    assert checkpoint.restore_state(d)["x"].tolist() == [2.0] * 4
