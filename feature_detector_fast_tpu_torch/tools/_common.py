"""What the port's tools share: the benchmark frame, the device and its
card line, the timers and the record printer."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ..api import _device
from ..utils.image import load_luma8

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MEDIA = os.path.join(REPO, "media")
#: Pixels of a 1920 x 1080 frame: the tools size their batches by it.
PX_1080P = 1920 * 1080


def build_1080p_frame() -> np.ndarray:
    """The benchmark frame, as the JAX package's ``bench.build_1080p_frame``
    makes it: the ``INPUT_FILE`` environment variable names a real frame;
    the default is the committed natural-statistics 1080p frame
    ``media/golden_1080p.png`` (24130 OFF keypoints at t=16, n=9); without
    it, the 300 x 200 reference frame tiled to 1920 x 1080."""
    override = os.environ.get("INPUT_FILE")
    if override:
        return load_luma8(override)
    golden = os.path.join(MEDIA, "golden_1080p.png")
    if os.path.exists(golden):
        return load_luma8(golden)
    small = load_luma8(os.path.join(MEDIA, "Screenshot315_torch_grey.png"))
    return np.tile(small, (-(-1080 // small.shape[0]), -(-1920 // small.shape[1])))[:1080, :1920].copy()


def card_line(device: torch.device) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` gives it, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(device.index)],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def start(device) -> Tuple[torch.device, str]:
    """Resolve ``device`` ("cuda", the default of every tool, raises without
    CUDA), print its card line on stderr and return both."""
    dev = _device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line(dev)
    print(f"device: {card}", file=sys.stderr, flush=True)
    return dev, card


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_cuda(fn, *, repeats: int = 7, inner: int = 5) -> float:
    """Median over ``repeats`` of the mean ms of ``inner`` calls, by CUDA
    events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        for _ in range(inner):
            fn()
        end_ev.record()
        end_ev.synchronize()
        times.append(start_ev.elapsed_time(end_ev) / inner)
    return float(np.median(times))


def time_host(fn, *, repeats: int = 7) -> float:
    """Median host-clock ms of ``fn`` up to a device synchronisation, after a
    warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


#: Device cycles of the sleep queued ahead of a timed window (~2 ms at the
#: H100's 1.98 GHz boost clock, longer at lower clocks).
AHEAD_CYCLES = 1 << 22


def fold(acc: torch.Tensor, out) -> None:
    """Add every tensor of ``out`` (a tensor, or a tuple or list of them)
    into the int64 accumulator ``acc``, on the device: each output of a
    timed round is consumed there."""
    if isinstance(out, torch.Tensor):
        acc.add_(out.sum(dtype=torch.int64).to(acc.device))
    else:
        for o in out:
            fold(acc, o)


def loop_ms(fn: Callable, device: torch.device, *, rounds: int, repeats: int = 3,
            folded: bool = True) -> float:
    """The JAX tools' device loop: ``rounds`` calls of ``fn`` on inputs
    already on the device, each output folded into a device accumulator
    (:func:`fold`; ``folded=False`` times the calls alone), after a warm-up
    call.  Returns the median over ``repeats`` of the ms per round: between
    two CUDA events on the card, by the host clock on the CPU.  On the card
    the rounds are queued behind a ~2 ms device sleep (:data:`AHEAD_CYCLES`),
    so where the host enqueues all of them within it the events time the
    device alone (a ctypes wrapper takes ~30 us to launch a call that may run
    for less); a round whose host work outlasts its device work is still
    timed as the device waits for it."""
    acc = torch.zeros((), dtype=torch.int64, device=device)

    def one_round():
        out = fn()
        if folded:
            fold(acc, out)

    one_round()
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start_ev = torch.cuda.Event(enable_timing=True)
            end_ev = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(AHEAD_CYCLES)
            start_ev.record()
            for _ in range(rounds):
                one_round()
            end_ev.record()
            end_ev.synchronize()
            times.append(start_ev.elapsed_time(end_ev) / rounds)
        else:
            t0 = time.perf_counter()
            for _ in range(rounds):
                one_round()
            times.append((time.perf_counter() - t0) * 1e3 / rounds)
    int(acc)  # the accumulator is read: no round is left unfinished
    return float(np.median(times))


def tiled(base: np.ndarray, h: int, w: int) -> np.ndarray:
    """An h x w frame tiled from ``base`` (its corner statistics kept)."""
    return np.tile(base, (-(-h // base.shape[0]), -(-w // base.shape[1])))[:h, :w].copy()


def batch_of(frame: np.ndarray, n: int, device: torch.device) -> torch.Tensor:
    """``n`` copies of ``frame`` as one (n, H, W) u8 batch on ``device``."""
    return torch.from_numpy(np.broadcast_to(frame, (n,) + frame.shape).copy()).to(device)


def parser(doc: str, rounds: Optional[int] = None) -> argparse.ArgumentParser:
    """An argument parser with the tools' common ``--device`` flag, and a
    ``--rounds`` flag where ``rounds`` gives its default."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    if rounds is not None:
        ap.add_argument("--rounds", type=int, default=rounds,
                        help=f"timed rounds (default {rounds})")
    return ap


def print_records(records: Iterable[dict]) -> int:
    """Print each record as one JSON line on stdout."""
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)
