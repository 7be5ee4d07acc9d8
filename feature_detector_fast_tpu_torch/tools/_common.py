"""What the port's tools share: the benchmark frame, the device and its
card line, the timers, the kernels' bounds on the H100 (bytes and integer
operations counted from the shapes and the data of a call) and the record
printer."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..api import _device
from ..ops import exp_off, fast
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


#: The H100 SXM peaks a kernel's bound is taken against (NVIDIA's data
#: sheet, 700 W): HBM bytes per second, and int32 lane-operations per
#: second -- 64 INT32 lanes x 132 SMs x 1.98 GHz, the clock behind the
#: published 67 TFLOP/s fp32.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 64 * 132 * 1.98e9

#: Integer operations of the FAST kernels.  The cardinal prefilter, at
#: every detectable pixel: 8 cardinal compares, 6 adds, 2 compares against
#: the need and the OR.  The arc test: 16 bright and 16 dark compares and
#: 16 for the two wraparound run tests, of which a pixel that passed the
#: prefilter still needs all but the 8 cardinal compares.  At an arc-test
#: corner only (elsewhere the score is 0, and a 0 is never kept), the 3x3
#: nonmax and the score (:func:`fast_score_ops`).
FAST_PREFILTER_OPS = 17
FAST_ARC_OPS = 48
FAST_CARDINAL_COMPARES = 8
FAST_NONMAX_OPS = 9


def fast_score_ops(mode: str, count: int) -> int:
    """Operations of one corner's score in ``csrc/fast.cu``.  MaxThreshold:
    16 differences, 2 x 16 3-input min/max for the windows of 3 and 2 x 16
    for those of 9, 2 x 16 more for two overlapping 9s where count > 9, 2 x
    8 for the max and min over the 16 starts, 2 absolutes and the min.
    SumAbsolute: 2 x 16 differences, 2 x 16 add-then-max, the max."""
    if mode == "max_threshold":
        return 16 + 64 + (32 if count > 9 else 0) + 16 + 3
    return {"off": 0, "sum_absolute": 65}[mode]


def fast_work(images: torch.Tensor, threshold: int, count: int) -> dict:
    """What a FAST call's operations depend on in the (B, H, W) u8 batch
    ``images``, counted frame by frame with the plain versions: the
    detectable pixels (x in [3, W-4], y in [3, H-4]), those of them that
    pass the cardinal prefilter, and the arc-test corners.  Beside them, for
    reading a kernel's time and not for its bound: the warp rows (32
    aligned columns of one row) and those that hold a candidate, where a
    warp cannot skip the 16-tap test."""
    b, h, w = images.shape
    candidates = corners = busy = 0
    for frame in images:
        cand = exp_off.prefilter_mask(frame[None], threshold, count)[0]
        candidates += int(cand.sum())
        busy += int(F.pad(cand, (0, -w % 32)).reshape(h, -1, 32).any(-1).sum())
        corners += int(fast.detect_mask(frame, threshold, count).sum())
    return {"pixels": b * max(h - 6, 0) * max(w - 6, 0), "candidates": candidates,
            "corners": corners, "warp_rows": b * h * -(-w // 32), "busy_warp_rows": busy}


def bound(nbytes: float, int_ops: float) -> dict:
    """The least time the card could take for work that moves ``nbytes``
    (each input byte read once, each output byte written once) and does
    ``int_ops`` integer lane-operations: the larger of the two times at the
    H100's peaks, and which one it is."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = int_ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": int(nbytes), "int_ops": int(int_ops)}


def fast_bound(frames: int, rows: int, width: int, mode: str, count: int, work: dict, *,
               words: bool, in_bytes: Optional[int] = None) -> dict:
    """Bound of one FAST kernel call (``csrc/fast.cu``) writing ``rows`` x
    ``width`` pixels of each of ``frames`` buffers, whose input holds the
    :func:`fast_work` ``work``.  ``in_bytes`` is the input tensor's size (a
    tiles stack's slabs and pitch); by default the pixels themselves."""
    px = frames * rows * width
    out = frames * rows * -(-width // 32) * 4 if words else px * 4  # words, or 2 u16 planes
    ops = (work["pixels"] * FAST_PREFILTER_OPS
           + work["candidates"] * (FAST_ARC_OPS - FAST_CARDINAL_COMPARES))
    if mode != "off":
        ops += work["corners"] * (FAST_NONMAX_OPS + fast_score_ops(mode, count))
    return bound((px if in_bytes is None else in_bytes) + out, ops)


#: Integer lane-operations a pixel of ``fdf_brief_words`` must issue: 256
#: pattern compares and the 8 adds of the separable 5x5 box sum, all on
#: u16 values (a sum is at most 6375), two of which one 32-bit lane-operation
#: handles (the kernel compares two pixels with one add).
BRIEF_OPS_PER_PX = (256 + 8) // 2


def brief_words_bound(frames: int, height: int, width: int) -> dict:
    """``fdf_brief_words``: :data:`BRIEF_OPS_PER_PX` a pixel; one byte in,
    8 int32 words out."""
    px = frames * height * width
    return bound(px + px * 32, px * BRIEF_OPS_PER_PX)


def window_union_px(xy: np.ndarray, height: int, width: int, *, lo: int, size: Tuple[int, int],
                    clamp: int) -> int:
    """Pixels of the frames that at least one keypoint window covers:
    ``xy`` (B, K, 2) is clamped to [clamp, dim - 1 - clamp], and each
    window spans rows y - lo .. y - lo + size[0] - 1 and columns x - lo ..
    x - lo + size[1] - 1, cut to the frame."""
    xy = np.asarray(xy)
    total = 0
    for pts in xy:
        x = np.clip(pts[:, 0], clamp, width - 1 - clamp) - lo
        y = np.clip(pts[:, 1], clamp, height - 1 - clamp) - lo
        diff = np.zeros((height + 1, width + 1), np.int32)
        y0, y1 = np.clip(y, 0, height), np.clip(y + size[0], 0, height)
        x0, x1 = np.clip(x, 0, width), np.clip(x + size[1], 0, width)
        for a, b, v in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
            np.add.at(diff, (a, b), v)
        total += int((diff.cumsum(0).cumsum(1)[:height, :width] > 0).sum())
    return total


def extract_windows_bound(xy: np.ndarray, height: int, width: int) -> dict:
    """``fdf_extract_windows``: the 35 x 35 u8 blur halos of the keypoints
    (each covered pixel read once), their (B, K, 2) int32 coordinates, and
    (B, K, 31, 31) int32 out; per output 8 blur adds and a shift-or."""
    n = int(np.prod(np.shape(xy)[:-1]))
    read = window_union_px(xy, height, width, lo=17, size=(35, 35), clamp=17)
    return bound(read + n * 8 + n * 31 * 31 * 4, n * 31 * 31 * 10)


def extract_patches_bound(xy: np.ndarray, height: int, width: int) -> dict:
    """``fdf_extract_patches``: the int32 plane cells the (32, 128) windows
    cover, read once, the coordinates, and (B, K, 32, 128) int32 out; a
    copy, no operations."""
    n = int(np.prod(np.shape(xy)[:-1]))
    read = window_union_px(xy, height, width, lo=15, size=(32, 128), clamp=15)
    return bound(read * 4 + n * 8 + n * 32 * 128 * 4, 0)


#: Integer operations per pixel of the OFF-floor stages (``csrc/exp_off.cu``):
#: LOAD ``px & 1``; TRIPLE two XORs and the AND; PREFILTER the FAST
#: kernels' cardinal prefilter.
FLOOR_OPS = {"load": 1, "triple": 3, "prefilter": FAST_PREFILTER_OPS}


def floor_bound(stage: str, frames: int, height: int, width: int) -> dict:
    """An OFF-floor stage over a (B, H, W) u8 batch: the frames in, words out."""
    px = frames * height * width
    return bound(px + frames * height * -(-width // 32) * 4, px * FLOOR_OPS[stage])


def words_prepacked_bound(plane_bytes: int, frames: int, height: int, width: int, count: int,
                          work: dict) -> dict:
    """``fdf_fast_words_prepacked``: the work of ``fdf_fast_words`` OFF, which
    computes the same words, on the frames the plane holds (their
    :func:`fast_work` ``work``: the prefilter at every detectable pixel, the
    arc test where it passes); the prepacked int32 plane in, words out."""
    return fast_bound(frames, height, width, "off", count, work, words=True,
                      in_bytes=plane_bytes)


#: Integer operations per int32 element of the SWAR predicate sequences
#: (``ops/exp_off.py``), the fewest the sequence needs, with 3-input logic
#: as one operation and the tap step folded into per-tap constants.
#: pred16, per tap and polarity: the biased add, the shift and the masked
#: OR.  pred8, per tap: the tap step and the low 7 bits of p, then per
#: polarity about 6 for the biased difference, the byte sign and the moved
#: bit.  Then one XOR.
SWAR_OPS = {"pred16": 16 * 2 * 3 + 1, "pred8": 16 * (2 + 2 * 6) + 1}


def swar_pred_bound(name: str, elements: int) -> dict:
    """A SWAR predicate kernel over three int32 planes of ``elements``
    elements, one int32 plane out."""
    return bound(elements * 16, elements * SWAR_OPS[name])


def baseline_library(binding, path: Optional[str], device: torch.device):
    """Another revision of a kernel source at ``path`` (same C interface),
    built beside the current one and bound by ``binding.bind``; None without
    ``path``.  Raises off the card: a before/after is a device measurement."""
    if path is None:
        return None
    if device.type != "cuda":
        raise ValueError("--baseline needs the card")
    from ..utils import cuda_build

    return binding.bind(cuda_build.load(path))


def same_loop_ms(fns: Dict[str, Callable], device: torch.device, *, rounds: int, repeats: int,
                 what: str) -> Dict[str, float]:
    """Mean device ms a call of each of ``fns`` ("current", and "baseline",
    the same call on another revision of the kernel, where given: its
    outputs, a tensor or a tuple of them, are checked equal first), timed by
    :func:`loop_ms` unfolded in the order baseline, current, current,
    baseline."""
    if "baseline" in fns:
        got, want = (out if isinstance(out, tuple) else (out,)
                     for out in (fns["current"](), fns["baseline"]()))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{what}: current != baseline")
        order = ["baseline", "current", "current", "baseline"]
    else:
        order = ["current"]
    times: Dict[str, list] = {name: [] for name in fns}
    for name in order:
        times[name].append(loop_ms(fns[name], device, rounds=rounds, repeats=repeats,
                                   folded=False))
    return {name: float(np.mean(t)) for name, t in times.items()}


def dispatch_counts(fn: Callable, device: torch.device) -> dict:
    """What one call of ``fn`` asks of the card: ``kernels`` launched (device
    events of ``torch.profiler`` other than copies and sets), ``copies``
    (memcpy / memset events), ``launch_calls`` (the host's kernel-launch API
    calls), host ``syncs`` (the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``, one a synchronizing call),
    ``device_ms`` (the device events' summed durations, not the union of
    their intervals) and ``wall_ms`` (another call, without the profiler, by
    the host clock up to a device synchronisation).  The two come from two
    calls and ``device_ms`` sums overlapping events, so they give no idle
    share: the benchmark's ``device_idle_pct`` does.  Each count is null
    where its source recorded nothing, and all are null on the CPU."""
    keys = ("kernels", "copies", "launch_calls", "syncs", "device_ms", "wall_ms")
    if device.type != "cuda":
        return dict.fromkeys(keys)
    import warnings

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    kernels = copies = launches = device_ns = 0
    # The raw events: ``prof.events()`` would first build a tree of Python
    # objects from them, tens of seconds for the ~68k kernels of a bundle
    # adjustment.
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device_ns += e.duration_ns()
            if e.name().startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
        elif "LaunchKernel" in e.name():
            launches += 1
    return {"kernels": kernels or None, "copies": copies if kernels else None,
            "launch_calls": launches or None, "syncs": syncs,
            "device_ms": device_ns / 1e6 if kernels else None, "wall_ms": wall_ms}


def timed_stage(fn: Callable, device: torch.device
                ) -> Tuple[object, float, Optional[int], Optional[int]]:
    """(``fn()``, its seconds by the host clock up to a device
    synchronisation, the stage's own peak bytes -- the device's
    ``torch.cuda.max_memory_allocated`` over the call less what was
    allocated when it began -- and that peak itself, which also counts what
    earlier work left allocated).  Both byte counts are None on the CPU."""
    held = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    sec = time.perf_counter() - t0
    if held is None:
        return out, sec, None, None
    peak = torch.cuda.max_memory_allocated(device)
    return out, sec, peak - held, peak


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
