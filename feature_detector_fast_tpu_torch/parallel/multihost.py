"""Multi-host orchestration: initialization, failure detection, and
preemption-safe execution.

Counterpart of ``feature_detector_fast_tpu.parallel.multihost``.  The
process group is ``torch.distributed``'s (NCCL between cards, gloo on the
CPU).  What the framework owns:

  * ``initialize()`` -- idempotent process-group setup, from explicit
    arguments or torchrun's environment (a no-op single-host),
  * ``healthcheck()`` -- an all-reduce heartbeat across ranks; a hung or
    dead peer surfaces as a timeout here, the practical failure detector,
  * ``CheckpointedLoop`` -- preemption-safe iteration: periodic saves plus
    resume-from-latest, the standard recovery pattern for preemptible
    fleets.

The multi-device paths of this package (``parallel/mesh.py``) drive every
device of a host from one process; a group joins such processes across
hosts.
"""

from __future__ import annotations

import datetime
import logging
import os
import threading
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils import checkpoint as ckpt
from . import mesh as meshlib

_log = logging.getLogger(__name__)

_initialized = False

#: torchrun's environment markers: with any of them set, ``initialize()``
#: tries the ``env://`` rendezvous.
_CLUSTER_ENV_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _init_method(coordinator_address: Optional[str]) -> Optional[str]:
    """``host:port`` -> ``tcp://host:port``; a URL with a scheme (``file://``,
    ``tcp://``, ``env://``) passes through; None -> ``env://``."""
    if coordinator_address is None or "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def _form_group(backend: str, init_method: Optional[str], world_size: Optional[int],
                rank: Optional[int], timeout_s: float) -> None:
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs CUDA; pass backend='gloo' for the CPU")
    kw = {} if world_size is None else {"world_size": world_size}
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    if backend == "nccl":  # one card a rank: torchrun's LOCAL_RANK, else the rank's turn
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "nccl",
    timeout_s: float = 60.0,
) -> int:
    """Form the multi-host process group (idempotent).  Explicit arguments
    are passed through, and a failure raises; with none, the ``env://``
    rendezvous runs whenever torchrun's MASTER_ADDR / WORLD_SIZE / RANK is
    set, and a failure there warns and continues single-host; with neither
    this is a no-op.  ``backend="gloo"`` forms the group on the CPU; the
    default, nccl, raises without CUDA.  ``timeout_s`` bounds the
    rendezvous.  Returns this process's rank (0 without a group)."""
    global _initialized
    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
    )
    auto = any(os.environ.get(v) for v in _CLUSTER_ENV_VARS)
    if not _initialized and not _group() and explicit:
        _form_group(backend, _init_method(coordinator_address), num_processes, process_id,
                    timeout_s)
        _initialized = True
    elif not _initialized and not _group() and auto:
        # Best effort, as the reference's pod auto-detection: a stray marker
        # must not stop a single-host run, but SAY SO: a real cluster
        # misconfiguration otherwise degrades to a silent single-host run.
        try:
            _form_group(backend, "env://", None, None, timeout_s)
            _initialized = True
        except (ValueError, RuntimeError) as e:
            _log.warning(
                "torch.distributed env:// initialization failed (%s: %s); "
                "continuing single-host.  If this IS a multi-host job, "
                "pass coordinator_address/num_processes/process_id "
                "explicitly.", type(e).__name__, e)
    return dist.get_rank() if _group() else 0


def shutdown() -> None:
    """Leave the process group, if any (``jax.distributed.shutdown``)."""
    global _initialized
    if _group():
        dist.destroy_process_group()
    _initialized = False


#: At most ONE heartbeat collective is ever in flight: a wedged peer blocks
#: the all-reduce indefinitely, and re-issuing a new collective per call
#: would accumulate one blocked daemon thread per healthcheck against a
#: dead cluster.
_hc_lock = threading.Lock()
_hc_inflight: Dict[str, Any] = {"thread": None}


def _heartbeat_collective(devices: Optional[Sequence] = None) -> bool:
    """The actual heartbeat: a 1 on each local device (default: every
    visible CUDA device), summed on the first, then all-reduced across the
    group's ranks with the number of devices each rank counted; True iff
    every device's 1 comes back."""
    devs = [torch.device(d) for d in devices] if devices is not None else meshlib.cuda_devices()
    ones = [torch.ones((), dtype=torch.int64, device=d) for d in devs]
    local = torch.stack([o.to(devs[0]) for o in ones]).sum()
    if _group():
        where = (torch.device("cuda", torch.cuda.current_device())
                 if dist.get_backend() == "nccl" else torch.device("cpu"))
        counts = torch.stack([local.to(where), torch.tensor(len(devs), device=where)])
        dist.all_reduce(counts)
        local, expected = counts.tolist()
    else:
        local, expected = int(local), len(devs)
    return int(local) == int(expected)


def healthcheck(
    timeout_s: float = 60.0,
    _collective: Optional[Callable[[], bool]] = None,
    *,
    devices: Optional[Sequence] = None,
) -> bool:
    """Cross-host heartbeat.  Returns True iff the heartbeat collective
    completes within ``timeout_s`` with every device's count.

    The collective runs in a daemon thread so a WEDGED peer -- the failure
    this detector exists for, which blocks the all-reduce indefinitely --
    turns into a timely False instead of hanging the caller.  The in-flight
    collective is a singleton: while a previous heartbeat is still blocked,
    further healthchecks return False immediately instead of stacking more
    blocked threads (the answer is already "unhealthy").  Callers are
    expected to checkpoint and abort so the scheduler restarts the job.

    ``devices`` are the local devices the default heartbeat counts (every
    visible CUDA device if None; ``[torch.device("cpu")]`` on the CPU).
    ``_collective`` is a test seam replacing the heartbeat."""
    fn = _collective or (lambda: _heartbeat_collective(devices))
    with _hc_lock:
        prev = _hc_inflight["thread"]
        if prev is not None and prev.is_alive():
            return False
        result: Dict[str, Any] = {}

        def run():
            try:
                result["ok"] = fn()
            except Exception as e:  # noqa: BLE001 -- any failure is a failed heartbeat
                _log.warning("heartbeat collective failed: %s: %s",
                             type(e).__name__, e)
                result["ok"] = False

        t = threading.Thread(target=run, daemon=True)
        _hc_inflight["thread"] = t
        t.start()
    t.join(timeout_s)
    return bool(result.get("ok", False))


class CheckpointedLoop:
    """Preemption-safe iteration driver.

    Wraps a step function with resume-from-latest and periodic saves:

        loop = CheckpointedLoop(dir, every=50)
        state, start = loop.resume(init_state)
        for step in range(start, n_steps):
            state = step_fn(state)
            loop.maybe_save(step, state)
    """

    def __init__(self, directory: str, every: int = 100):
        self.directory = directory
        self.every = int(every)

    def resume(self, init_state: Dict[str, Any]):
        """Returns (state, next_step): restored from the latest checkpoint
        if one exists (each leaf in ``init_state``'s form), else
        (init_state, 0)."""
        step = ckpt.latest_step(self.directory)
        if step is None:
            return init_state, 0
        state = ckpt.restore_state(self.directory, step, init_state)
        return state, step + 1

    def maybe_save(self, step: int, state: Dict[str, Any]) -> bool:
        """Save every `every` steps; rank 0 writes (single-writer)."""
        if (step + 1) % self.every != 0:
            return False
        if (dist.get_rank() if _group() else 0) == 0:
            ckpt.save_state(self.directory, step, state)
        return True
