"""The port's debug and tracing tools against the JAX package's.

Mirrors tests/test_debug_multihost.py's debug tests and
tests/test_io_utils.py's ``test_tracing_flag``: the NaN tripwire raises
inside its scope and not after it; ``assert_finite`` names the same leaf
as JAX's ``keystr``; ``assert_replicas_identical`` on stacks and per-device
lists; ``dump_plane_hex`` prints the same strings as the JAX package;
``trace`` the same line.  A CPU ``profile`` trace holds its ``annotate``
span.
"""

import glob
import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.utils import debug as jdebug
from feature_detector_fast_tpu.utils import tracing as jtracing
from feature_detector_fast_tpu_torch.utils import debug, tracing


class Pair(NamedTuple):
    a: object
    b: object


def test_nan_checking_trips_in_scope_only():
    x = torch.tensor([-1.0, 2.0])
    with debug.nan_checking():
        assert torch.isfinite(x.exp()).all()
        assert torch.equal(torch.arange(3, dtype=torch.int32) + 1, torch.tensor([1, 2, 3],
                                                                                dtype=torch.int32))
        inf = torch.tensor([1.0]) / torch.zeros(1)  # Inf passes, as in JAX
        assert torch.isinf(inf).all()
        with pytest.raises(FloatingPointError, match="torch.log"):
            torch.log(x)
        with pytest.raises(FloatingPointError, match="sqrt_"):
            x.clone().sqrt_()  # in place
        with pytest.raises(FloatingPointError):
            torch.sort(torch.log(x))  # a tuple result; log trips first
        y = x.clone()
        with pytest.raises(FloatingPointError, match="__setitem__"):
            y[0] = float("nan")
    # and is off afterwards
    assert torch.isnan(torch.log(x)).any()


def test_nan_checking_pops_when_the_body_raises():
    with pytest.raises(ValueError):
        with debug.nan_checking():
            raise ValueError("body")
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_assert_finite_matches_jax_message():
    good = {"a": np.ones(3), "b": [torch.ones(2), (np.int32(1), None)]}
    debug.assert_finite(good, "state")
    jdebug.assert_finite({"a": np.ones(3)}, "state")
    bad = {"z": [np.ones(2), Pair(np.ones(1), {"q": np.asarray([1.0, np.nan])})],
           "a": np.ones(3), "i": np.asarray([1, 2])}
    with pytest.raises(FloatingPointError) as want:
        jdebug.assert_finite(bad, "state")
    for tree in (bad, {**bad, "z": [torch.ones(2), Pair(torch.ones(1),
                                                         {"q": torch.tensor([1.0, np.inf])})]}):
        with pytest.raises(FloatingPointError) as got:
            debug.assert_finite(tree, "state")
        assert str(got.value) == str(want.value) == "non-finite values in state['z'][1].b['q']"
    with pytest.raises(FloatingPointError, match=r"state\['a'\]"):
        debug.assert_finite({"a": np.asarray([1.0, np.nan])}, "state")


def test_assert_replicas_identical():
    good = np.stack([np.arange(4)] * 3)
    for per_device in (good, torch.from_numpy(good), [torch.arange(4)] * 3):
        debug.assert_replicas_identical(per_device)
    bad = good.copy()
    bad[2, 1] = 99
    for per_device in (bad, [torch.from_numpy(r) for r in bad]):
        with pytest.raises(AssertionError, match="replica 2 differs"):
            debug.assert_replicas_identical(per_device)
    with pytest.raises(AssertionError):
        jdebug.assert_replicas_identical(bad)
    close = [torch.ones(3, dtype=torch.bfloat16), torch.ones(3) + 1e-4]
    debug.assert_replicas_identical(close, atol=1e-3)
    with pytest.raises(AssertionError, match="deviates"):
        debug.assert_replicas_identical(close, atol=1e-6)


@pytest.mark.parametrize("plane", [
    np.asarray([[1, 255], [16, 0]]),
    np.asarray([[1, -1], [0x2000, 0]]),
    np.random.default_rng(3).integers(0, 256, (12, 40), np.uint8),
    np.random.default_rng(4).integers(-2**31, 2**31, (5, 9), np.int64).astype(np.int32),
    np.zeros((0, 4), np.int32),
], ids=["u8", "i32", "u8-corner", "i32-random", "empty"])
def test_dump_plane_hex_matches_jax(plane):
    want = jdebug.dump_plane_hex(plane)
    assert debug.dump_plane_hex(plane) == want
    assert debug.dump_plane_hex(torch.from_numpy(plane)) == want
    assert debug.dump_plane_hex(plane, 3, 5) == jdebug.dump_plane_hex(plane, 3, 5)


def test_dump_plane_hex_pins():
    assert debug.dump_plane_hex(np.asarray([[1, 255], [16, 0]])).splitlines() == ["01 ff",
                                                                                 "10 00"]
    assert debug.dump_plane_hex(np.asarray([[1, -1], [0x2000, 0]])).splitlines() == [
        "00000001 ffffffff", "00002000 00000000"]


def test_tracing_flag_matches_jax(monkeypatch, capsys):
    assert tracing.TRACE_ENV == jtracing.TRACE_ENV == "FDF_TRACE"
    outs = []
    for mod in (jtracing, tracing):
        monkeypatch.setenv(tracing.TRACE_ENV, "0")
        mod.trace("hidden")
        assert not mod.tracing_enabled()
        monkeypatch.setenv(tracing.TRACE_ENV, "1")
        mod.trace("shown", 42)
        assert mod.tracing_enabled()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == "[fdf] shown 42\n"
    for value, on in (("", False), ("false", False), ("yes", True)):
        monkeypatch.setenv(tracing.TRACE_ENV, value)
        assert tracing.tracing_enabled() is jtracing.tracing_enabled() is on


def test_profile_trace_holds_the_span(tmp_path):
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with tracing.profile(str(tmp_path), device="cpu") as prof:
        with tracing.annotate("fdf_span"):
            (x @ x).sum()
    [path] = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "fdf_span" for e in events)
    assert any(e.key == "fdf_span" for e in prof.key_averages())


def test_profile_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA profiling is chip_smoke.py's")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tracing.profile(str(tmp_path)):
            pass
