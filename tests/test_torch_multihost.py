"""The port's multihost module: heartbeat, initialization, resume loop.

Mirrors tests/test_debug_multihost.py's multihost tests with the CPU as
the local device: a healthy heartbeat; the wedged-collective seam answers
False within its timeout, answers at once while the wedged heartbeat is
still in flight, starts no further thread, and is healthy again after the
release; ``initialize()`` is a single-host no-op without torchrun's
variables; ``CheckpointedLoop`` resumes after its last save.  Then a real
two-rank gloo group: two processes meet through a ``file://`` store, both
heartbeats come back, only rank 0 writes the checkpoints, and both ranks
resume the same state.  The processes are bounded at 60 s, so a hung
rendezvous fails the test rather than stalling the suite.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from feature_detector_fast_tpu_torch.parallel import multihost

CPU = [torch.device("cpu")]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def test_healthcheck_local_devices():
    assert multihost.healthcheck(devices=CPU) is True
    assert multihost.healthcheck(devices=CPU * 3) is True


def test_healthcheck_exception_is_a_failed_heartbeat():
    def broken():
        raise RuntimeError("peer reset")

    assert multihost.healthcheck(timeout_s=10.0, _collective=broken) is False
    assert multihost.healthcheck(devices=CPU) is True


def test_healthcheck_timeout_returns_false_promptly():
    """A wedged peer blocks the heartbeat collective forever; the caller
    must get False within ~timeout_s, and subsequent healthchecks must not
    stack additional blocked threads (singleton in-flight collective)."""
    release = threading.Event()

    def wedged():
        release.wait(30.0)  # simulates an all-reduce blocked on a dead host
        return True

    t0 = time.perf_counter()
    ok = multihost.healthcheck(timeout_s=0.2, _collective=wedged)
    dt = time.perf_counter() - t0
    assert ok is False
    assert dt < 5.0, dt
    # the wedged collective is still in flight: immediate False, no new thread
    t0 = time.perf_counter()
    assert multihost.healthcheck(timeout_s=10.0, _collective=wedged) is False
    assert time.perf_counter() - t0 < 1.0
    n_threads = threading.active_count()
    for _ in range(5):
        assert multihost.healthcheck(timeout_s=10.0, _collective=wedged) is False
    assert threading.active_count() <= n_threads
    release.set()  # unblock; healthy heartbeat works again afterwards
    time.sleep(0.05)
    assert multihost.healthcheck(timeout_s=10.0, devices=CPU) is True


@pytest.fixture()
def no_torchrun(monkeypatch):
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    yield
    multihost.shutdown()


def test_initialize_single_host_noop(no_torchrun):
    assert multihost.initialize() == 0
    assert not torch.distributed.is_initialized()


def test_initialize_bad_torchrun_env_warns_and_continues(no_torchrun, monkeypatch, caplog):
    # WORLD_SIZE without RANK: the env:// rendezvous raises at once
    monkeypatch.setenv("WORLD_SIZE", "2")
    with caplog.at_level("WARNING"):
        assert multihost.initialize(backend="gloo", timeout_s=5.0) == 0
    assert "continuing single-host" in caplog.text
    assert not torch.distributed.is_initialized()


def test_initialize_explicit_failure_raises(no_torchrun, tmp_path):
    with pytest.raises(RuntimeError, match="rank < size"):  # a rank outside the world
        multihost.initialize(f"file://{tmp_path}/store", 2, 5, backend="gloo", timeout_s=5.0)
    assert not torch.distributed.is_initialized() and multihost.initialize() == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl backend needs CUDA"):
            multihost.initialize("localhost:1", 1, 0)


def test_initialize_one_rank_group(no_torchrun, tmp_path):
    store = f"file://{tmp_path}/store"
    assert multihost.initialize(store, 1, 0, backend="gloo", timeout_s=30.0) == 0
    assert torch.distributed.is_initialized() and torch.distributed.get_world_size() == 1
    assert multihost.initialize(store, 1, 0, backend="gloo") == 0  # idempotent
    assert multihost.healthcheck(devices=CPU * 2) is True
    multihost.shutdown()
    assert not torch.distributed.is_initialized()


def test_checkpointed_loop_resume(tmp_path, rng):
    loop = multihost.CheckpointedLoop(str(tmp_path / "ck"), every=2)
    state = {"w": rng.normal(0, 1, (4,)).astype(np.float32),
             "step": np.int32(0)}
    st, start = loop.resume(state)
    assert start == 0
    # run 5 steps, saving at steps 1 and 3
    for step in range(5):
        st = {"w": st["w"] + 1, "step": np.int32(step)}
        loop.maybe_save(step, st)
    st2, start2 = loop.resume(state)
    assert start2 == 4  # resumed after the step-3 save
    np.testing.assert_allclose(st2["w"], state["w"] + 4, rtol=1e-6)
    assert st2["w"].dtype == np.float32 and st2["step"].dtype == np.int32
    assert int(st2["step"]) == 3


#: One rank of the two-rank test, run as its own process (no conftest, no JAX).
RANK_MAIN = r"""
import json, sys
import numpy as np
import torch
from feature_detector_fast_tpu_torch.parallel import multihost

rank, store, ckdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
got = multihost.initialize(store, 2, rank, backend="gloo", timeout_s=50.0)
again = multihost.initialize(store, 2, rank, backend="gloo")
healthy = multihost.healthcheck(30.0, devices=[torch.device("cpu")] * (rank + 1))
writes = []
save = multihost.ckpt.save_state
multihost.ckpt.save_state = lambda d, step, s: (writes.append(step), save(d, step, s))
loop = multihost.CheckpointedLoop(ckdir, every=2)
init = {"w": np.arange(4, dtype=np.float32), "step": np.int32(0)}
st, start = loop.resume(init)
for step in range(5):
    st = {"w": st["w"] + 1, "step": np.int32(step)}
    loop.maybe_save(step, st)
torch.distributed.barrier()
st2, start2 = loop.resume(init)
multihost.shutdown()
print(json.dumps({"rank": got, "again": again, "healthy": healthy, "writes": writes,
                  "start": start, "start2": start2, "w": st2["w"].tolist(),
                  "step": int(st2["step"])}))
"""


def test_two_rank_gloo_group(tmp_path):
    env = {**{k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS},
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    store, ckdir = f"file://{tmp_path}/store", str(tmp_path / "ck")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_MAIN, str(r), store, ckdir],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(tmp_path))
             for r in (0, 1)]
    outs = []
    deadline = time.monotonic() + 60.0
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [o["rank"] for o in outs] == [o["again"] for o in outs] == [0, 1]
    assert all(o["healthy"] for o in outs)
    assert outs[0]["writes"] == [1, 3] and outs[1]["writes"] == []
    assert all(o["start"] == 0 and o["start2"] == 4 for o in outs)
    assert outs[0]["w"] == outs[1]["w"] == [4.0, 5.0, 6.0, 7.0]
    assert outs[0]["step"] == outs[1]["step"] == 3
