#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card (bit-exact: the outputs
are integers, so the tolerance is zero), drives the main path -- ``detect``,
``detect_arrays``, ``detect_batch_arrays``, ``DetectorPipeline`` and
``detect_strongest_arrays`` on ``device="cuda"`` -- against the golden
keypoint counts and FNV hashes, checks through the launch counters that the
main path ran the kernels, and times kernel, plain version and end-to-end
batch detection at (16, 1080, 1920).

Before its last line it prints the card (``nvidia-smi`` name and power
limit) and one JSON object ``{"kernels": [...]}``; its last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

#: Golden pins, as in tests/test_golden.py: (mode, keypoints, FNV-1a hash)
#: at threshold 16, count 9.
GOLDEN_REF = [("off", 309, 0x9C9E48257E77AB23),
              ("max_threshold", 131, 0x0808251D63604630),
              ("sum_absolute", 135, 0x826FDD2651736590)]
GOLDEN_1080P = [("off", 24130, 0xE063E6EF93A53E63),
                ("max_threshold", 4457, 0xB11E93BC5D76998C),
                ("sum_absolute", 6469, 0x4D1BE1E2206B3ADA)]
REF_IMAGE_HASH = 0x509FCFE2E529AFCE
IMAGE_1080P_HASH = 0x49E1A4ECF6FAE94F

BATCH = 16


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def log(*args) -> None:
    print(*args, flush=True)


def time_cuda(fn, *, repeats: int = 7, inner: int = 5) -> float:
    """Median over ``repeats`` of the mean ms of ``inner`` calls, by CUDA
    events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import feature_detector_fast_tpu_torch as port
    from feature_detector_fast_tpu_torch import api, serving
    from feature_detector_fast_tpu_torch.config import Config, NonmaxMode
    from feature_detector_fast_tpu_torch.ops import compact, fast, fast_cuda
    from feature_detector_fast_tpu_torch.utils import cuda_build
    from feature_detector_fast_tpu_torch.utils.hashing import hash_image, hash_keypoints
    from feature_detector_fast_tpu_torch.utils.image import load_luma8

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    fast_cuda.load_library()
    log(f"build: csrc/fast.cu in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for line in cuda_build.build_log("fast.cu").splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    modes = list(NonmaxMode)
    ref = load_luma8(os.path.join(REPO, "media", "Screenshot315_torch_grey.png"))
    g1080 = load_luma8(os.path.join(REPO, "media", "golden_1080p.png"))
    check(hash_image(ref) == REF_IMAGE_HASH, "reference frame changed")
    check(hash_image(g1080) == IMAGE_1080P_HASH, "golden_1080p frame changed")

    # 16 distinct frames: the 1080p frame rolled along x and y.
    batch = np.stack([np.roll(g1080, (7 * i, 97 * i), axis=(0, 1)) for i in range(BATCH)])

    # -- 2. kernels against the plain version, on the card -----------------
    rng = np.random.default_rng(0x5EED)
    inputs = {
        "rand_3x61x157": rng.integers(0, 256, (3, 61, 157), np.uint8),
        "rand_2x256x320": rng.integers(0, 256, (2, 256, 320), np.uint8),
        "rand_2x7x9": rng.integers(0, 256, (2, 7, 9), np.uint8),
        "ref_200x300": ref[None],
        "golden_1080x1920": g1080[None],
        f"batch_{BATCH}x1080x1920": batch,
    }
    max_err = {"words": 0, "dense": 0}
    for name, arr in inputs.items():
        imgs = torch.from_numpy(arr).to(dev)
        thresholds = (0, 16, 60) if name.startswith("rand") else (16,)
        n_cfg = 0
        for mode in modes:
            for count in range(9, 17):
                for t in thresholds:
                    p_mask, p_score = fast.detect_dense(imgs, t, count, mode)
                    p_words = compact.pack_mask_words(p_mask)
                    k_words = fast_cuda.detect_words(imgs, t, count, mode)
                    torch.cuda.synchronize()
                    k_mask, k_score = fast_cuda.detect_dense(imgs, t, count, mode)
                    torch.cuda.synchronize()
                    e_w = int((k_words.to(torch.int64) - p_words.to(torch.int64)).abs().max())
                    e_d = max(
                        int((k_mask.to(torch.int32) - p_mask.to(torch.int32)).abs().max()),
                        int((k_score.to(torch.int32) - p_score.to(torch.int32)).abs().max()))
                    max_err["words"] = max(max_err["words"], e_w)
                    max_err["dense"] = max(max_err["dense"], e_d)
                    check(e_w == 0 and e_d == 0,
                          f"kernel != plain on {name}, {mode.value}, count {count}, "
                          f"t {t}: words err {e_w}, dense err {e_d}")
                    n_cfg += 1
        log(f"kernel vs plain: {name} {tuple(arr.shape)}: {n_cfg} configs "
            f"(3 modes x counts 9..16 x t {thresholds}) bit-exact, words and dense")

    # -- 3. the main path, counted -----------------------------------------
    for key in fast_cuda.LAUNCHES:
        fast_cuda.LAUNCHES[key] = 0

    for (mode, n, h), (_, n_1080, h_1080) in zip(GOLDEN_REF, GOLDEN_1080P):
        cfg = Config(16, 9, NonmaxMode(mode))
        pts = port.detect(ref, cfg)  # device="cuda" is the default
        check(len(pts) == n and hash_keypoints(pts) == h,
              f"detect(reference, {mode}): {len(pts)} keypoints, hash {hash_keypoints(pts):#x}")
        xy = port.detect_arrays(g1080, cfg, device="cuda")
        check(len(xy) == n_1080 and hash_keypoints(xy) == h_1080,
              f"detect_arrays(1080p, {mode}): {len(xy)} keypoints, hash {hash_keypoints(xy):#x}")
        log(f"main path: detect {mode}: reference {len(pts)}, 1080p {len(xy)} keypoints, "
            f"hashes match")

    batches = [np.roll(batch, j, axis=0) for j in range(4)]
    for mode in modes:
        cfg = Config(16, 9, mode)
        singles = [port.detect_arrays(f, cfg) for f in batch]
        got = api.detect_batch_arrays(batch, cfg)
        check(len(got) == BATCH and all(np.array_equal(a, b) for a, b in zip(got, singles)),
              f"detect_batch_arrays != per-frame detect_arrays ({mode.value})")
        _, n = api.detect_batch_device(batch, cfg)
        check(n.device.type == "cuda" and n.tolist() == [len(s) for s in singles],
              f"detect_batch_device counts ({mode.value})")
        pipe = serving.DetectorPipeline(cfg, depth=2)
        out = []
        for b in batches:
            pipe.submit(b)
            out.extend(pipe.ready())
        out.extend(pipe.drain())
        check(len(out) == len(batches), "pipeline lost a batch")
        for j, lists in enumerate(out):
            # frame i of batches[j] is batch[(i - j) % BATCH]
            check(all(np.array_equal(a, singles[(i - j) % BATCH]) for i, a in enumerate(lists)),
                  f"DetectorPipeline != detect_arrays ({mode.value}, batch {j})")
        log(f"main path: {mode.value}: detect_batch_arrays {batch.shape}, detect_batch_device "
            f"and DetectorPipeline(depth=2) x{len(batches)} batches equal per-frame "
            f"detect_arrays ({sum(len(s) for s in singles)} keypoints)")

    for mode in (NonmaxMode.MAX_THRESHOLD, NonmaxMode.SUM_ABSOLUTE):
        cfg = Config(16, 9, mode)
        xy_g, t_g = api.detect_strongest_arrays(g1080, cfg, k=1000)
        xy_c, t_c = api.detect_strongest_arrays(g1080, cfg, k=1000, device="cpu")
        check(t_g == t_c and np.array_equal(xy_g, xy_c),
              f"detect_strongest_arrays cuda != cpu ({mode.value}): t* {t_g} vs {t_c}")
        check(len(xy_g) >= 1000, "strongest-K returned fewer than k")
        log(f"main path: detect_strongest_arrays {mode.value} k=1000: {len(xy_g)} keypoints, "
            f"t*={t_g}, equal to the CPU run")

    launches = dict(fast_cuda.LAUNCHES)
    log(f"main path launches: {launches}")
    check(launches["words"] > 0, "the main path never launched the words kernel")
    check(launches["dense"] > 0, "the main path never launched the dense kernel")

    # -- 4. timing at (16, 1080, 1920) -------------------------------------
    imgs = torch.from_numpy(batch).to(dev)
    timing = {}
    for mode in modes:
        args = (imgs, 16, 9, mode)
        cfg = Config(16, 9, mode)
        words = fast_cuda.detect_words(*args)
        points = compact.words_to_points(words)

        def pipeline():
            pipe = serving.DetectorPipeline(cfg, depth=2)
            for b in batches:
                pipe.submit(b)
                list(pipe.ready())
            list(pipe.drain())

        r = {
            "words_ms": time_cuda(lambda: fast_cuda.detect_words(*args)),
            "plain_words_ms": time_cuda(
                lambda: compact.pack_mask_words(fast.detect_dense(*args)[0]),
                repeats=5, inner=2),
            "dense_ms": time_cuda(lambda: fast_cuda.detect_dense(*args)),
            "plain_dense_ms": time_cuda(lambda: fast.detect_dense(*args), repeats=5, inner=2),
            # detect_batch_arrays end to end, host array in, lists out ...
            "e2e_ms": time_host(lambda: api.detect_batch_arrays(batch, cfg)),
            # ... and its stages besides the kernel
            "h2d_ms": time_host(lambda: torch.from_numpy(batch).to(dev)),
            "decode_ms": time_host(lambda: compact.words_to_points(words)),
            "split_ms": time_host(lambda: compact.split_frames(points, BATCH)),
            # DetectorPipeline(depth=2), per batch of a 4-batch stream
            "pipeline_ms": time_host(pipeline, repeats=5) / len(batches),
        }
        timing[mode.value] = r
        log(f"timing {mode.value} ({BATCH}, 1080, 1920), ms per frame: "
            + ", ".join(f"{k[:-3]} {v / BATCH:.4f}" for k, v in r.items()))

    rows = []
    for kname, key, line in (("fdf_fast_words", "words", 949), ("fdf_fast_dense", "dense", 621)):
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": "feature_detector_fast_tpu_torch/csrc/fast.cu",
            "replaces": f"feature_detector_fast_tpu/ops/fast_pallas.py:{line}",
            "launches": launches[key],
            "max_abs_err": max_err[key],
            "ms": timing["max_threshold"][f"{key}_ms"],
            "plain_ms": timing["max_threshold"][f"plain_{key}_ms"],
            "timed_at": f"one ({BATCH}, 1080, 1920) call, t=16, n=9, max_threshold",
            "ms_by_mode": {m: timing[m][f"{key}_ms"] for m in timing},
            "plain_ms_by_mode": {m: timing[m][f"plain_{key}_ms"] for m in timing},
        })
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
