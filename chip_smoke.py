#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, all at once), holds each kernel against its plain PyTorch
version on the card (bit-exact: the outputs are integers, so the tolerance
is zero), and drives its main paths on ``device="cuda"``, each with the
launch counters zeroed just before it and read just after:

* detection -- ``detect``, ``detect_arrays``, ``detect_batch_arrays``,
  ``DetectorPipeline`` and ``detect_strongest_arrays`` -- against the golden
  keypoint counts and FNV hashes;
* the front-end -- ``detect_and_describe_batch`` (patched, steered and dense
  BRIEF routes), ``match`` on consecutive frames and
  ``detect_and_describe_multiscale`` -- against the port's CPU path and the
  front-end pins computed with the JAX package;
* the multi-device front-end on ``cuda:0`` repeated (the machine has one
  card) -- row-sharded ``detect_arrays_rows_sharded`` / ``detect_rows_sharded``
  at 1080p, 4K and 8192 px wide, ``detect_batch_sharded`` over 4 shards and
  the 3-stage ``frontend_pipelined`` -- against the golden pins and the
  single-device paths;
* the tools -- each ``feature_detector_fast_tpu_torch.tools`` module's
  ``run()`` at 2 rounds: acceptance, the resolution, sweep, serving,
  front-end and scaling benchmarks, and the OFF-floor experiments on the
  kernels of ``csrc/exp_off.cu`` -- against the golden counts and their own
  bit-exact checks.
* visual odometry (``vo_phase``) -- the 64-frame 640 x 480 circuit of
  ``tools.vo_bench`` rendered once, K=512: (a) the card's features of 9
  frames equal to the CPU path's, and ``estimate_pairs`` on 8 pairs
  against the port's CPU path on the same draws (the ``VO_*`` gates); (b)
  ``vo_bench.run`` with host and device-resident frames: finite poses, ATE
  under 4% of the trajectory, one ``fdf_fast_dense`` and one
  ``fdf_extract_windows`` launch a run, frames/s, the stage split and the
  kernels, syncs and device time of one ``estimate_pairs``; (c) loop
  proposal and ``run_vo_matches`` with the loops, no BA: at least one
  accepted loop edge; then both kernels bit-exact against their plain
  versions at the path's shapes, and the odometry ATE at 6 RANSAC seeds
  (its spread, printed).  The geometry is plain PyTorch (the JAX package
  computes none of it in a Pallas kernel).

It then times the FAST kernels' device time against their bounds
(``tools.fast_bench``: words and dense at 1, 16 and 64 frames of 1080p,
the row-shard forms on one frame in 8 shards), the descriptor kernels' and
the patched-vs-dense describe crossover at (16, 1080, 1920)
(``tools.descriptor_bench``), and kernels, plain versions, batch
detection, the front-end, the row-shard kernels and multi-device paths against
their single-device counterparts, and the experiment kernels.  Every
kernel's row in the ``kernels`` line carries its bound (``tools._common``:
bytes at 3.35 TB/s or integer operations at 16.7 T/s, from this run's
shapes and data), its launches on its main path, and ``library_ms`` null
with the reason no single PyTorch call computes the same function.  The
build's ``-Xptxas -v`` log gives registers, shared memory and spills of
every kernel; a spill in any source, or an OFF instantiation of
``fast.cu`` above 32 registers, fails the run.  The descriptor kernels are
also held bit-exact on their tilings' edges, the OFF-floor strip
kernels on 8- and 32-row strips, frames narrower and lower than a strip,
and planes that need element loads, and the streaming floors on widths
their 16-byte path takes (1920, 16, 48) and ones it does not, on bases 1
B and 4 B past a 16-byte boundary, and at spans 128, 8, 1, 3, H and past
H; these two are also timed at 64 frames.

Before its last line it prints the card (``nvidia-smi`` name and power
limit) and one JSON object ``{"kernels": [...]}``; its last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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

#: Front-end pins, as in tests/test_torch_frontend.py: FNV-1a feature hashes
#: (utils.hashing.hash_features) of the JAX package's detect_and_describe,
#: SumAbsolute t=16 n=9, keyed (frame, k, oriented) ...
FEATURE_PINS = {
    ("reference", 1000, False): 0x9DFC8FB5BDCBF569,
    ("reference", 1000, True): 0x388726B3B877F7CD,
    ("reference", 2048, False): 0x9DFC8FB5BDCBF569,
    ("reference", 2048, True): 0x388726B3B877F7CD,
    ("1080p", 1000, False): 0x8EE8957A31276C4B,
    ("1080p", 1000, True): 0xC7C83C1D8AFCFD6A,
    ("1080p", 2048, False): 0xAF7E3C6B14A54E15,
    ("1080p", 2048, True): 0xCC085CBB02549D45,
}
#: ... and the matches between frames 0 and 1 of the batch below, k=1000,
#: keyed by oriented.
MATCH_PIN = {False: 926, True: 926}

BATCH = 16
SOURCES = ("fast.cu", "brief.cu", "patch.cu", "exp_off.cu")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def log(*args) -> None:
    print(*args, flush=True)


def near_half_bins(image: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """(K,) bool: the float64 value atan2(m01, m10) / 2pi * 30 of each
    keypoint's 31 x 31 intensity-centroid moments lies within 1e-4 of a
    half-integer, where float32 atan2 may round the orientation bin apart
    on two devices."""
    r = 15
    pad = np.pad(image.astype(np.int64), r)
    d = np.arange(-r, r + 1)
    out = np.zeros(len(xy), bool)
    for i, (x, y) in enumerate(xy):
        patch = pad[y: y + 2 * r + 1, x: x + 2 * r + 1]
        v = np.arctan2((patch * d[:, None]).sum(), (patch * d[None, :]).sum()) / (2 * np.pi) * 30
        out[i] = abs(v - np.floor(v) - 0.5) < 1e-4
    return out


def compare_features(got, want, image: np.ndarray, oriented: bool, what: str) -> int:
    """CUDA front-end output == the CPU path's: keypoints and descriptor
    validity exactly, descriptor words at valid slots.  For steered BRIEF a
    slot may differ only where its orientation lies within 1e-4 bins of a
    bin edge; returns the number of such slots."""
    (kps, desc, dvalid), (c_kps, c_desc, c_dvalid) = got, want
    for name, g, e in zip(("xy", "score", "valid"), kps, c_kps):
        check(torch.equal(g.cpu(), e), f"{what}: keypoint {name} differ from the CPU path")
    check(torch.equal(dvalid.cpu(), c_dvalid), f"{what}: descriptor validity differs")
    differ = (desc.cpu().numpy() != c_desc.numpy()).any(-1) & c_dvalid.numpy()
    bad = differ & ~near_half_bins(image, c_kps.xy.numpy()) if oriented else differ
    check(not bad.any(), f"{what}: {int(bad.sum())} valid descriptors differ from the CPU path")
    return int(differ.sum())


def feature_hash(kps, desc, dvalid) -> int:
    from feature_detector_fast_tpu_torch.utils.hashing import hash_features

    return hash_features(kps.xy.cpu(), kps.score.cpu(), kps.valid.cpu(), desc.cpu(), dvalid.cpu())


MODE_NAMES = ("off", "max_threshold", "sum_absolute")


def ptxas_entries(build_log: str):
    """(entry function, registers, shared-memory bytes, spill bytes) for each
    kernel of an ``nvcc -Xptxas -v`` log."""
    out, name, spill = [], None, 0
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m[1], 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name is not None:
            out.append((name, int(m[1]), int(m[2] or 0), spill))
            name = None
    return out


#: The VO phase's gates for the card against the port's CPU path on the same
#: correspondences and RANSAC draws, float32, TF32 off: 8 consecutive pairs
#: of the rendered VGA circuit at K=512, 256 hypotheses, 6 Gauss-Newton
#: iterations.  Measured on an H100: pair rotations 0.00021 deg apart
#: (median), 0.0124 at most; equal inlier sets; ray depths 1.4e-3 apart
#: (median, relative).  The gates leave 7x to 50x of margin.
VO_PAIRS = 8
VO_MAX_MEDIAN_ROT_DEG = 0.01
VO_MAX_ROT_DEG = 0.1
VO_MIN_INLIER_AGREEMENT = 0.999
VO_MAX_MEDIAN_DEPTH_REL = 0.01
#: The float32 image-level gate of tests/test_render_vo.py:47.
VO_MAX_ATE_PCT = 4.0


def vo_phase(dev: torch.device, zero_counts, counts, max_err: dict) -> dict:
    """The VO main path on the card (``tools.vo_bench``'s F=64 VGA circuit,
    K=512), each part with the launch counters zeroed just before it:

    (a) the card's features of 9 frames equal to the CPU path's, and
        ``estimate_pairs`` on the card against the port's CPU path, on the
        same correspondences and draws (``VO_*`` gates);
    (b) ``vo_bench.run`` for host and device-resident frames (a warm-up
        run, then a timed one each): finite poses, ATE under
        ``VO_MAX_ATE_PCT``, one ``fdf_fast_dense`` and one
        ``fdf_extract_windows`` launch a run and no ``fdf_brief_words``;
    (c) ``propose_loop_closures(gap=10, top_k=8)`` and ``run_vo_matches``
        with the loop pairs (no BA): a finite trajectory with at least one
        accepted loop edge.

    Then, uncounted, the path's two kernels against their plain versions at
    its shapes (``fdf_fast_dense`` on the (64, 480, 640) stack,
    ``fdf_extract_windows`` at (c)'s 512 keypoints a frame; bit-exact, into
    ``max_err``), and the ATE of the odometry path at RANSAC seeds 1-5 and
    three times at seed 0, the spread that ``VO_MAX_ATE_PCT``'s margin is
    read against (reported, not gated).

    ``counts()`` reads the launch counters.  Returns the numbers the
    caller prints and puts in the kernels line."""
    from feature_detector_fast_tpu_torch.config import NonmaxMode
    from feature_detector_fast_tpu_torch.models import slam
    from feature_detector_fast_tpu_torch.ops import fast, fast_cuda, patch_cuda
    from feature_detector_fast_tpu_torch.tools import vo_bench

    t0 = time.perf_counter()
    seq = vo_bench.sequence(64)
    gt, frames = seq
    log(f"vo: rendered the 64-frame 640x480 circuit in {time.perf_counter() - t0:.1f} s "
        f"(host, {min(8, os.cpu_count() or 1)} processes)")
    cam = vo_bench.render_config().camera()
    vocfg = vo_bench.vo_config(64, cam)
    out = {}

    # (a) card against the CPU path on identical correspondences and draws
    zero_counts()
    sub = frames[:VO_PAIRS + 1]
    feats = slam.frontend_features(sub, vocfg, device=dev)
    c_xy, c_desc, c_dvalid = slam.frontend_features(sub, vocfg, device="cpu")
    check(torch.equal(feats[0].cpu(), c_xy) and torch.equal(feats[2].cpu(), c_dvalid)
          and torch.equal(feats[1].cpu()[c_dvalid], c_desc[c_dvalid]),
          "vo (a): the card's keypoints or descriptors differ from the CPU path's")
    log(f"vo (a): features of {len(sub)} frames at K=512 on the card == the CPU path's "
        f"(keypoints, validity, descriptors at {int(c_dvalid.sum())} valid slots)")
    batch = slam._as_pair_batch(slam.frontend_matches(sub, vocfg, features=feats, device=dev))
    draws = slam.ransac_draws(vocfg.seed, VO_PAIRS, vocfg.ransac_hypotheses, batch.valid.shape[1])
    t0 = time.perf_counter()
    card = slam.estimate_pairs(batch, vocfg, draws=draws, device=dev, dtype=torch.float32)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = slam.estimate_pairs(batch, vocfg, draws=draws, device="cpu", dtype=torch.float32)
    cpu_s = time.perf_counter() - t0
    # The angle of R_card^T R_cpu from its skew part and trace (atan2): an
    # arccos of the trace alone cannot resolve float32 matrices below ~0.03 deg.
    rel = card.R.astype(np.float64).transpose(0, 2, 1) @ cpu.R.astype(np.float64)
    skew = rel - rel.transpose(0, 2, 1)
    sin = np.linalg.norm(np.stack([skew[:, 2, 1], skew[:, 0, 2], skew[:, 1, 0]], 1), axis=1) / 2
    rot = np.degrees(np.arctan2(sin, (np.trace(rel, axis1=1, axis2=2) - 1) / 2))
    agree = float((card.inl == cpu.inl)[batch.valid].mean())
    both = card.inl & cpu.inl & (cpu.depths_a > 1e-6)
    depth_rel = float(np.median(np.abs(card.depths_a[both] - cpu.depths_a[both])
                                / cpu.depths_a[both]))
    out["vs_cpu"] = {"pairs": VO_PAIRS, "median_rot_deg": float(np.median(rot)),
                     "max_rot_deg": float(rot.max()), "inlier_agreement": agree,
                     "median_depth_rel": depth_rel, "card_s": card_s, "cpu_s": cpu_s,
                     "inliers_card": card.inl.sum(1).tolist(), "inliers_cpu": cpu.inl.sum(1).tolist()}
    log(f"vo (a): estimate_pairs card vs the CPU path, {VO_PAIRS} pairs of K=512, 256 "
        f"hypotheses, 6 GN: rotation difference median {np.median(rot):.5f} deg, max "
        f"{rot.max():.5f} deg; inlier agreement {agree:.5f}; ray depth median relative "
        f"difference {depth_rel:.2e}; inliers card {card.inl.sum(1).tolist()}, cpu "
        f"{cpu.inl.sum(1).tolist()}; {card_s:.2f} s card (first call), {cpu_s:.2f} s CPU")
    check(np.median(rot) <= VO_MAX_MEDIAN_ROT_DEG and rot.max() <= VO_MAX_ROT_DEG,
          f"vo (a): rotation difference median {np.median(rot)} / max {rot.max()} deg")
    check(agree >= VO_MIN_INLIER_AGREEMENT, f"vo (a): inlier agreement {agree}")
    check(depth_rel <= VO_MAX_MEDIAN_DEPTH_REL, f"vo (a): ray depth difference {depth_rel}")

    # (b) the slice at full width, host and device-resident frames
    runs = vo_bench.run(device=dev, seq=seq)
    for resident in (False, True):
        zero_counts()
        rec = next(runs)
        n = counts()
        check(rec["resident"] == resident and rec["poses_finite"], f"vo (b): {rec}")
        check(rec["ate_pct_of_trajectory"] < VO_MAX_ATE_PCT,
              f"vo (b): ATE {rec['ate_pct_of_trajectory']}% of the trajectory")
        # a warm-up run and a timed run
        check(n["fdf_fast_dense"] == 2 and n["fdf_extract_windows"] == 2
              and n["fdf_brief_words"] == 0, f"vo (b): launches {n} over two runs")
        tag = "resident" if resident else "host"
        out[tag] = dict(rec, launches_per_run={k: v // 2 for k, v in n.items()})
        stages = {k: v for k, v in rec.items() if k.endswith("_s") and k != "total_s"}
        log(f"vo (b) {tag} frames: {rec['frames']} frames in {rec['total_s']:.3f} s = "
            f"{rec['frames_per_sec']:.2f} f/s, ATE {rec['ate_pct_of_trajectory']:.3f}% of the "
            f"trajectory; stages (s) {json.dumps(stages)}; launches a run "
            f"{out[tag]['launches_per_run']}; estimate_pairs over {rec['estimate_pairs_pairs']} "
            f"pairs: {json.dumps(rec['estimate_pairs_dispatch'])}")

    # (c) loops without BA, on the same features
    zero_counts()
    feats = slam.frontend_features(frames, vocfg, device=dev)
    pd = slam.frontend_matches(frames, vocfg, features=feats, device=dev)
    t0 = time.perf_counter()
    loops = slam.propose_loop_closures(frames, vocfg, gap=10, top_k=8, features=feats,
                                       device=dev)
    propose_s = time.perf_counter() - t0
    mets, st = [], {}
    t0 = time.perf_counter()
    est = slam.run_vo_matches(pd, vocfg, loop_pairs=loops, metrics=mets, stage_times=st,
                              device=dev)
    geo_s = time.perf_counter() - t0
    edges = sum(1 for m in mets if m.get("edge_added"))
    drift = sum(1 for m in mets if m.get("loop_closure") and m.get("log_drift") is not None)
    traj = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    ate = 100.0 * slam.evaluate_ate(est, gt) / traj
    check(np.isfinite(est).all(), "vo (c): trajectory with loops is not finite")
    check(edges >= 1, f"vo (c): no loop edge accepted of {len(loops)} proposed")
    out["loops"] = {"proposed": len(loops), "accepted": sum(1 for m in mets if m.get("loop_closure")),
                    "edges": edges, "drift_observations": drift, "ate_pct_of_trajectory": ate,
                    "propose_s": propose_s, "geometry_s": geo_s, **{f"geo.{k}_s": v for k, v in st.items()},
                    "launches": counts()}
    log(f"vo (c): loops without BA: {len(loops)} proposed (gap 10, top 8), "
        f"{out['loops']['accepted']} accepted, {edges} SE(3) edges, {drift} drift observations; "
        f"ATE {ate:.3f}% with loops vs {out['host']['ate_pct_of_trajectory']:.3f}% odometry; "
        f"propose {propose_s:.3f} s, geometry {geo_s:.3f} s, stages (s) {json.dumps(st)}")

    # The path's two kernels against their plain versions at its shapes.
    def err(a: torch.Tensor, b: torch.Tensor) -> int:
        torch.cuda.synchronize()
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    stack = torch.from_numpy(np.stack(frames)).to(dev)
    args = (stack, vocfg.threshold, vocfg.count, NonmaxMode.SUM_ABSOLUTE)
    (k_mask, k_score), (p_mask, p_score) = fast_cuda.detect_dense(*args), fast.detect_dense(*args)
    e_d = max(err(k_mask, p_mask), err(k_score, p_score))
    e_w = err(patch_cuda.extract_windows_fused(stack, feats[0]),
              patch_cuda.extract_windows_plain(stack, feats[0]))
    max_err["dense"] = max(max_err["dense"], e_d)
    max_err["extract_windows"] = max(max_err["extract_windows"], e_w)
    check(e_d == 0 and e_w == 0, f"vo: at the path's shapes, dense err {e_d}, windows err {e_w}")
    log(f"vo: kernels vs plain at the path's shapes: fdf_fast_dense on {tuple(stack.shape)} "
        f"(SumAbsolute, t {vocfg.threshold}, count {vocfg.count}), fdf_extract_windows at "
        f"{tuple(feats[0].shape[:2])} keypoints, bit-exact")

    # ATE's spread, against which VO_MAX_ATE_PCT's margin is read: other
    # RANSAC seeds, and seed 0 again (the card's scatter_add_ sums are not
    # deterministic).
    spread = {}
    for seed in (0, 0, 0, 1, 2, 3, 4, 5):
        est = slam.run_vo_matches(pd, dataclasses.replace(vocfg, seed=seed), device=dev)
        spread.setdefault(str(seed), []).append(100.0 * slam.evaluate_ate(est, gt) / traj)
    every = [a for v in spread.values() for a in v]
    out["ate_spread"] = {"by_seed": spread, "min": min(every), "max": max(every),
                         "gate": VO_MAX_ATE_PCT}
    log(f"vo: odometry ATE (% of the trajectory) by RANSAC seed {json.dumps(spread)}; "
        f"{min(every):.3f}-{max(every):.3f} against the gate {VO_MAX_ATE_PCT}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import feature_detector_fast_tpu_torch as port
    from feature_detector_fast_tpu_torch import api, serving
    from feature_detector_fast_tpu_torch.config import Config, NonmaxMode
    from feature_detector_fast_tpu_torch.models import brief, match, pyramid
    from feature_detector_fast_tpu_torch.models.brief import Keypoints
    from feature_detector_fast_tpu_torch.ops import (
        brief_cuda, compact, exp_off, exp_off_cuda, fast, fast_cuda, patch_cuda)
    from feature_detector_fast_tpu_torch.parallel import (
        frontend as dp, mesh as meshlib, pipeline, spatial)
    from feature_detector_fast_tpu_torch.tools import (
        _common, acceptance, descriptor_bench, exp_off_byteswar, exp_off_floor, exp_off_prepack,
        fast_bench, frontend_bench, resolution_bench, scaling_bench, serving_bench, sweep)
    from feature_detector_fast_tpu_torch.tools._common import loop_ms, time_cuda, time_host
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
    cuda_build.build_all(SOURCES)
    for lib in (fast_cuda, brief_cuda, patch_cuda, exp_off_cuda):
        lib.load_library()
    log(f"build: csrc/{{{','.join(SOURCES)}}} in {time.perf_counter() - t0:.2f} s, in parallel "
        f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for source in SOURCES:
        if source == "fast.cu":
            continue
        for name, regs, smem, spill in ptxas_entries(cuda_build.build_log(source)):
            log(f"  ptxas {source} {name}: registers {regs}, smem {smem} B (static), "
                f"spills {spill} B")
            check(spill == 0, f"{source} {name} spills {spill} B")
    # fast.cu: one instantiation per count x mode x form x strip height;
    # registers, shared memory and spills per mode, form and height.
    fast_ptxas = {}
    for name, regs, smem, spill in ptxas_entries(cuda_build.build_log("fast.cu")):
        m = re.search(r"fast_kernelILi(\d+)ELi(\d)ELb(\d)ELb(\d)ELi(\d+)E", name)
        check(m is not None, f"unexpected entry function in fast.cu: {name}")
        key = (MODE_NAMES[int(m[2])], ("words" if m[3] == "1" else "dense")
               + ("_tiles" if m[4] == "1" else "") + f", {m[5]}-row strips")
        fast_ptxas.setdefault(key, []).append((int(m[1]), regs, smem, spill))
    check(len(fast_ptxas) == 24 and all(len(v) == 8 for v in fast_ptxas.values()),
          "fast.cu: expected 8 counts x 3 modes x 4 forms x 2 strip heights")
    for (mode_name, form), v in sorted(fast_ptxas.items()):
        regs = [r for _, r, _, _ in v]
        log(f"  ptxas fast.cu {mode_name} {form}, counts 9..16: registers "
            f"{min(regs)}-{max(regs)} ({' '.join(str(r) for _, r, _, _ in sorted(v))}), "
            f"smem {max(sm for _, _, sm, _ in v)} B, spills {sum(sp for *_, sp in v)} B")
        check(all(sp == 0 for *_, sp in v), f"fast.cu {mode_name} {form} spills")
        check(mode_name != "off" or max(regs) <= 32,
              f"fast.cu off {form} uses {max(regs)} registers (> 32: below full occupancy)")

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
        # Heights off the 32-row strip, widths off the 32- and 128-column
        # grids, and odd H * W, so every frame after the first starts at
        # an unaligned address.
        "rand_3x45x157": rng.integers(0, 256, (3, 45, 157), np.uint8),
        "rand_3x37x1931": rng.integers(0, 256, (3, 37, 1931), np.uint8),
        "rand_1x70x8200": rng.integers(0, 256, (1, 70, 8200), np.uint8),
        "ref_200x300": ref[None],
        "golden_1080x1920": g1080[None],
        f"batch_{BATCH}x1080x1920": batch,
        "batch_4x1080x1920": batch[:4],  # 16-row strips (32 and 8 above)
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

    # -- 2b. the front-end kernels against their plain versions ------------
    max_err.update(brief_words=0, extract_windows=0, extract_patches=0)

    def err(a: torch.Tensor, b: torch.Tensor) -> int:
        torch.cuda.synchronize()
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0

    for name, arr in inputs.items():
        if min(arr.shape[1:]) < 35:
            continue
        imgs = torch.from_numpy(arr).to(dev)
        b, h, w = arr.shape
        e_b = err(brief_cuda.describe_words(imgs), brief_cuda.describe_words_plain(imgs))
        # 997 slots (a prime): in range, on the border and beyond it.
        xy = np.stack([rng.integers(-20, w + 20, (b, 997)), rng.integers(-20, h + 20, (b, 997))], -1)
        xy[:, :4] = [[0, 0], [w - 1, h - 1], [17, h - 18], [w - 16, 15]]
        xy = torch.from_numpy(xy.astype(np.int32)).to(dev)
        planes = brief.box_blur5(imgs)
        e_w = err(patch_cuda.extract_windows_fused(imgs, xy), patch_cuda.extract_windows_plain(imgs, xy))
        e_p = err(patch_cuda.extract_patches(planes, xy), patch_cuda.extract_patches_plain(planes, xy))
        for key, e in (("brief_words", e_b), ("extract_windows", e_w), ("extract_patches", e_p)):
            max_err[key] = max(max_err[key], e)
        check(e_b == 0 and e_w == 0 and e_p == 0,
              f"front-end kernel != plain on {name}: brief words err {e_b}, windows err {e_w}, "
              f"patches err {e_p}")
        log(f"kernel vs plain: {name} {tuple(arr.shape)}: BRIEF words on every pixel, windows and "
            f"patches at 997 fuzzed slots per frame, bit-exact")

    # The descriptor kernels' tilings: BRIEF's 64 x 32 blocks of 2-column
    # lanes (widths 1-3 past 64 and 128, heights off 32, 3 frames of odd
    # H * W so frames 1 and 2 start unaligned, 5 x 5 and 5 x 7 frames);
    # the windows' 8 keypoints a block and 4-slot store phase (K = 1, K off
    # 8, coordinates beyond every edge).
    edge_inputs = [(1, 5, 5), (2, 5, 7), (3, 65, 129), (1, 67, 130), (3, 63, 131),
                   (2, 128, 66), (3, 37, 1931), (1, 1081, 1923)]
    for shape in edge_inputs:
        imgs = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        e_b = err(brief_cuda.describe_words(imgs), brief_cuda.describe_words_plain(imgs))
        max_err["brief_words"] = max(max_err["brief_words"], e_b)
        check(e_b == 0, f"BRIEF words != plain on {shape}: err {e_b}")
        b, h, w = shape
        if min(h, w) < 35:
            continue
        for k in (1, 7, 9, 1001):
            xy = np.stack([rng.integers(-40, w + 40, (b, k)), rng.integers(-40, h + 40, (b, k))], -1)
            xy[:, :min(k, 4)] = [[-5, -5], [w + 5, h + 5], [-5, h + 5], [w + 5, -5]][:min(k, 4)]
            xy = torch.from_numpy(xy.astype(np.int32)).to(dev)
            e_w = err(patch_cuda.extract_windows_fused(imgs, xy),
                      patch_cuda.extract_windows_plain(imgs, xy))
            max_err["extract_windows"] = max(max_err["extract_windows"], e_w)
            check(e_w == 0, f"windows != plain on {shape}, K={k}: err {e_w}")
    log(f"kernel vs plain: BRIEF words on {len(edge_inputs)} tiling-edge shapes {edge_inputs} "
        f"and windows at K = 1, 7, 9, 1001 with coordinates beyond every edge, bit-exact")

    # -- 2c. the row-shard kernels against their plain version -------------
    max_err.update(words_tiles=0, dense_tiles=0)
    tiles_inputs = {"golden_1080x1920": g1080,
                    "rand_1037x1931": rng.integers(0, 256, (1037, 1931), np.uint8)}

    def check_tiles(name, ext, row0, halo, h, w, mode, count) -> None:
        kw = dict(height=h, width=w, halo=halo)
        p_mask, p_score = fast.detect_dense_tiles(ext, row0.tolist(), 16, count, mode, **kw)
        e_w = err(fast_cuda.detect_words_tiles(ext, row0, 16, count, mode, **kw),
                  compact.pack_mask_words(p_mask))
        k_mask, k_score = fast_cuda.detect_dense_tiles(ext, row0, 16, count, mode, **kw)
        e_d = max(err(k_mask, p_mask), err(k_score, p_score))
        max_err["words_tiles"] = max(max_err["words_tiles"], e_w)
        max_err["dense_tiles"] = max(max_err["dense_tiles"], e_d)
        check(e_w == 0 and e_d == 0,
              f"tiles kernel != plain on {name}, {mode.value}, count {count}: "
              f"words err {e_w}, dense err {e_d}")

    for name, arr in tiles_inputs.items():
        h, w = arr.shape
        for shards in (2, 8):
            rows = spatial.shard_rows(h, shards)
            [(_, ext, row0)] = spatial.shard_slabs(torch.from_numpy(arr), [dev] * shards, rows)
            for mode in modes:
                for count in range(9, 17):
                    check_tiles(name, ext, row0, spatial.HALO, h, w, mode, count)
            log(f"tiles kernels vs plain: {name} in {shards} shards of {rows} rows "
                f"(padded to {shards * rows}), halo {spatial.HALO}: 3 modes x counts 9..16, "
                f"bit-exact, words and dense")
    # The JAX package's 64-row halo, on 1080p in 8 shards.
    rows = spatial.shard_rows(1080, 8)
    wide = torch.nn.functional.pad(torch.from_numpy(g1080), (0, 0, 64, 64 + 8 * rows - 1080))
    ext64 = torch.stack([wide[s * rows:s * rows + rows + 128] for s in range(8)]).to(dev)
    row0_64 = torch.arange(8, dtype=torch.int32, device=dev) * rows
    for mode in modes:
        check_tiles("golden_1080x1920, halo 64", ext64, row0_64, 64, 1080, 1920, mode, 9)
    log("tiles kernels vs plain: golden_1080x1920 in 8 shards with 64-row halos: 3 modes, "
        "count 9, bit-exact")

    # -- 2d. the experiment kernels against their plain versions ----------
    max_err.update({key: 0 for key in exp_off_cuda.LAUNCHES})

    def check_prepacked(name: str, imgs: torch.Tensor, plane: torch.Tensor) -> None:
        _, h, w = imgs.shape
        for count in range(9, 17):
            for t in (0, 16, 32):
                got = exp_off_cuda.words_prepacked(plane, t, count, height=h, width=w)
                e = max(err(got, fast_cuda.detect_words(imgs, t, count, NonmaxMode.OFF)),
                        err(got, exp_off.words_prepacked(plane, t, count, height=h, width=w)))
                max_err["words_prepacked"] = max(max_err["words_prepacked"], e)
                check(e == 0, f"prepacked words != fdf_fast_words OFF / plain on {name}, "
                              f"count {count}, t {t}: err {e}")

    def check_floors(name: str, imgs: torch.Tensor) -> None:
        # TRIPLE at the tool's span 128, and at spans 8, 1, 3, H and past H
        # (one block: TRIPLE is LOAD).
        h = imgs.shape[1]
        triples = tuple((exp_off.TRIPLE, (span,)) for span in (128, 8, 1, 3, h, 2 * h + 1))
        for stage, args in ((exp_off.LOAD, ()), *triples,
                            (exp_off.PREFILTER, (16, 9)), (exp_off.PREFILTER, (16, 12))):
            e = err(exp_off_cuda.FLOORS[stage](imgs, *args), exp_off.FLOORS[stage](imgs, *args))
            max_err[f"floor_{stage}"] = max(max_err[f"floor_{stage}"], e)
            check(e == 0, f"floor {stage} {args} != plain on {name}: err {e}")

    # The strip kernels' edges: 32-row strips (the 16-frame batch), 8-row
    # strips (one 1080p frame, two of 1037 x 1931), frames lower than the
    # circle or narrower than a strip, and 130 x 131, whose last plane tile
    # has its high field past the frame.  The streaming floors' 16-byte
    # path: widths 1920 (two chunks a word), 16 (one) and 48 (a partial
    # last word of one chunk); the others take element loads.
    exp_inputs = {f"batch_{BATCH}x1080x1920": batch,
                  "golden_1x1080x1920": g1080[None],
                  "rand_2x1037x1931": rng.integers(0, 256, (2, 1037, 1931), np.uint8),
                  "rand_1x7x9": rng.integers(0, 256, (1, 7, 9), np.uint8),
                  "rand_1x5x200": rng.integers(0, 256, (1, 5, 200), np.uint8),
                  "rand_1x130x131": rng.integers(0, 256, (1, 130, 131), np.uint8),
                  "rand_3x37x16": rng.integers(0, 256, (3, 37, 16), np.uint8),
                  "rand_2x61x48": rng.integers(0, 256, (2, 61, 48), np.uint8)}
    for name, arr in exp_inputs.items():
        imgs = torch.from_numpy(arr).to(dev)
        check_floors(name, imgs)
        check_prepacked(name, imgs, exp_off.prepack(imgs))
        log(f"experiment kernels vs plain: {name} {arr.shape}: floors LOAD, TRIPLE (spans 128, "
            f"8, 1, 3, H, 2H + 1), PREFILTER (need 2 and 3) bit-exact; prepacked words == "
            f"fdf_fast_words OFF == plain at counts 9..16 x t (0, 16, 32)")
    # Batches the streaming floors load element by element for their base
    # alone: contiguous views 1 B and 4 B past a 16-byte boundary.
    for off in (1, 4):
        for name in (f"batch_{BATCH}x1080x1920", "rand_2x61x48"):
            imgs = torch.from_numpy(exp_inputs[name]).to(dev)
            shifted = torch.empty(imgs.numel() + off, dtype=torch.uint8,
                                  device=dev)[off:].view(imgs.shape)
            shifted.copy_(imgs)
            check(shifted.data_ptr() % 16 == off,
                  f"the shifted batch's base is not {off} B past 16")
            check_floors(f"{name}, base {off} B past 16", shifted)
    log("experiment kernels vs plain: floors on batches based 1 B and 4 B past a 16-byte "
        f"boundary (batch_{BATCH}x1080x1920, rand_2x61x48), every span, bit-exact")
    # Planes the prepacked kernel stages element by element: a pitch that is
    # not a multiple of 4 (131 columns of a 1037 x 131 frame's 256-column
    # plane), and a base 4 bytes past a 16-byte boundary.
    imgs = torch.from_numpy(rng.integers(0, 256, (1, 1037, 131), np.uint8)).to(dev)
    check_prepacked("rand_1x1037x131, pitch 131", imgs,
                    exp_off.prepack(imgs)[..., :131].contiguous())
    imgs = torch.from_numpy(exp_inputs["rand_2x1037x1931"]).to(dev)
    plane = exp_off.prepack(imgs)
    shifted = torch.empty(plane.numel() + 1, dtype=torch.int32, device=dev)[1:].view(plane.shape)
    shifted.copy_(plane)
    check(shifted.data_ptr() % 16 == 4, "the shifted plane's base is not 4 B past 16")
    check_prepacked("rand_2x1037x1931, base 4 B past 16", imgs, shifted)
    log("experiment kernels vs plain: prepacked words on a pitch-131 plane and on a plane "
        "based 4 B past a 16-byte boundary == fdf_fast_words OFF == plain at counts 9..16 x "
        "t (0, 16, 32)")
    # The byte-SWAR tool's seeded planes in [0, 2^30), and planes over the
    # whole int32 range, where the adds wrap.
    prng = np.random.default_rng(0)

    def pred_planes(rows_: int, low: int, high: int):
        return [torch.from_numpy(prng.integers(low, high, (64 * rows_, 128), np.int64)
                                 .astype(np.int32)).to(dev) for _ in range(3)]

    for low, high in ((0, 2**30), (-2**31, 2**31)):
        for key, rows_ in (("pred16", 256), ("pred8", 128)):
            xs = pred_planes(rows_, low, high)
            e = err(getattr(exp_off_cuda, f"swar_{key}")(*xs), getattr(exp_off, f"swar_{key}")(*xs))
            max_err[key] = max(max_err[key], e)
            check(e == 0, f"{key} != plain on planes in [{low}, {high}): err {e}")
    log("experiment kernels vs plain: pred16 (64x256, 128) and pred8 (64x128, 128) on the "
        "tool's seeded planes and on full-range int32 planes, bit-exact")

    # extract_patches runs on no main path (in the JAX package only the
    # tests call it); its launches are the kernel phase's.
    patches_launches = patch_cuda.LAUNCHES["extract_patches"]
    counters = (fast_cuda.LAUNCHES, brief_cuda.LAUNCHES, patch_cuda.LAUNCHES,
                exp_off_cuda.LAUNCHES)

    def zero_counts() -> None:
        for counts in counters:
            for key in counts:
                counts[key] = 0

    # -- 3. the detection main path, counted -------------------------------
    zero_counts()

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

    # -- 3b. the front-end main path, counted ------------------------------
    zero_counts()
    fe = {}
    # k=16384 lies above brief._dense_k_min at 1080p: the dense route.  Its 15
    # distance matrices would take 16 GB, so it is not matched.
    for k, oriented in ((1000, False), (1000, True), (2048, False), (16384, False)):
        kps, desc, dvalid = brief.detect_and_describe_batch(batch, 16, 9, k, oriented)
        n_match = None
        if k <= 2048:
            m = match.match(desc[:-1], dvalid[:-1], desc[1:], dvalid[1:])  # consecutive frames
            n_match = (m.idx_b >= 0).sum(-1)
        fe[(k, oriented)] = (kps, desc, dvalid, n_match)
    multi = pyramid.detect_and_describe_multiscale(g1080, 16, 9, 1000)
    singles = {("reference", k, o): brief.detect_and_describe(ref, 16, 9, k, o)
               for k in (1000, 2048) for o in (False, True)}
    singles[("1080p", 2048, True)] = brief.detect_and_describe(g1080, 16, 9, 2048, True)
    torch.cuda.synchronize()
    fe_launches = {"fdf_fast_dense": fast_cuda.LAUNCHES["dense"],
                   "fdf_brief_words": brief_cuda.LAUNCHES["brief_words"],
                   "fdf_extract_windows": patch_cuda.LAUNCHES["extract_windows"]}
    log(f"front-end main path launches: {fe_launches}")
    for kname, n in fe_launches.items():
        check(n > 0, f"the front-end main path never launched {kname}")

    for (k, oriented), (kps, desc, dvalid, n_match) in fe.items():
        check(kps.xy.shape == (BATCH, k, 2) and desc.shape == (BATCH, k, brief.WORDS)
              and dvalid.shape == (BATCH, k) and desc.device.type == "cuda"
              and desc.dtype == torch.int32, f"front-end output shapes at k={k}")
        route = "patched" if oriented or k <= brief._dense_k_min(*batch.shape[-2:]) else "dense"
        log(f"front-end: detect_and_describe_batch {batch.shape} k={k} "
            f"{'oriented' if oriented else 'plain'} ({route} route): "
            f"{int(kps.valid.sum())} keypoints, {int(dvalid.sum())} described"
            + (f"; matches of consecutive frames {n_match.tolist()}" if n_match is not None else ""))
        singles[("1080p", k, oriented)] = (Keypoints(*(f[0] for f in kps)), desc[0], dvalid[0])
        flips = 0
        for i in (0, 1):  # frames 0 and 1 against the CPU path
            cpu = brief.detect_and_describe(batch[i], 16, 9, k, oriented, device="cpu")
            flips += compare_features((Keypoints(*(f[i] for f in kps)), desc[i], dvalid[i]),
                                      cpu, batch[i], oriented, f"1080p frame {i}, k={k}")
        if k == 1000 and not flips:
            check(int(n_match[0]) == MATCH_PIN[oriented],
                  f"matches of frames 0 and 1: {int(n_match[0])}, pinned {MATCH_PIN[oriented]}")
        log(f"front-end: frames 0 and 1 equal the CPU path ({flips} steered slots on a bin "
            f"edge differ)")

    for key in sorted(FEATURE_PINS, key=str):
        image = ref if key[0] == "reference" else g1080
        cpu = brief.detect_and_describe(image, 16, 9, key[1], key[2], device="cpu")
        check(feature_hash(*cpu) == FEATURE_PINS[key], f"CPU path hash {key} != pin")
        flips = compare_features(singles[key], cpu, image, key[2], str(key))
        check(flips > 0 or feature_hash(*singles[key]) == FEATURE_PINS[key],
              f"CUDA path hash {key} != pin")
        log(f"front-end: {key}: CUDA path == CPU path == JAX pin {FEATURE_PINS[key]:#x}"
            + (f" ({flips} steered slots on a bin edge differ)" if flips else ""))

    cpu_multi = pyramid.detect_and_describe_multiscale(g1080, 16, 9, 1000, device="cpu")
    for name in ("xy0", "xy", "level", "score", "valid"):
        check(torch.equal(getattr(multi, name).cpu(), getattr(cpu_multi, name)),
              f"multiscale {name} differs from the CPU path")
    v = cpu_multi.valid
    check(torch.equal(multi.desc.cpu()[v], cpu_multi.desc[v]), "multiscale descriptors differ")
    log(f"front-end: detect_and_describe_multiscale(1080p, k=1000, 4 levels): "
        f"{multi.xy.shape[0]} slots, {int(v.sum())} valid, per level "
        f"{torch.bincount(multi.level.cpu()[v]).tolist()}, equal to the CPU path")

    # -- 3c. the multi-device front-end main path, counted -----------------
    # One card: every mesh repeats cuda:0, so each row-shard seam and each
    # pipeline hop still meets the kernels and the stream ordering.
    mesh8 = meshlib.make_mesh(devices=[dev] * 8)
    mesh4 = meshlib.make_mesh(devices=[dev] * 4)
    pipe_mesh = pipeline.make_pipe_mesh([dev] * 3)
    g4k = np.tile(g1080, (2, 2))
    g8192 = np.ascontiguousarray(np.tile(g1080, (1, 5))[:, :8192])
    imgs = torch.from_numpy(batch).to(dev)

    def sequential_frontend(oriented: bool):
        out, prev = [], None
        for frame in imgs:
            kps, desc, dvalid = brief.detect_and_describe(frame, 16, 9, 1000, oriented)
            m = match.match(desc, dvalid, *prev) if prev is not None else None
            out.append((kps, desc, dvalid, m))
            prev = (desc, dvalid)
        return out

    # The single-device references, before the counters are zeroed.
    ref_lists = {(size, mode): api.detect_arrays(frame, Config(16, 9, mode))
                 for size, frame in (("4K", g4k), ("8192w", g8192)) for mode in modes}
    ref_dense = {mode: fast_cuda.detect_dense(torch.from_numpy(g1080)[None].to(dev), 16, 9, mode)
                 for mode in modes}
    ref_batch = {mode: fast_cuda.detect_dense(imgs, 16, 9, mode) for mode in modes}
    ref_front = {o: sequential_frontend(o) for o in (False, True)}
    torch.cuda.synchronize()

    zero_counts()
    got_lists, got_dense, got_batch, got_front = {}, {}, {}, {}
    for mode in modes:
        got_lists[("1080p", mode)] = spatial.detect_arrays_rows_sharded(
            g1080, 16, 9, mode, mesh=mesh8)
        got_dense[mode] = spatial.detect_rows_sharded(g1080, 16, 9, mode, mesh=mesh8)
        for size, frame in (("4K", g4k), ("8192w", g8192)):
            got_lists[(size, mode)] = spatial.detect_arrays_rows_sharded(
                frame, 16, 9, mode, mesh=mesh8)
        got_batch[mode] = dp.detect_batch_sharded(imgs, 16, 9, mode, mesh=mesh4)
    for oriented in (False, True):
        got_front[oriented] = pipeline.frontend_pipelined(imgs, 16, 9, 1000, mesh=pipe_mesh,
                                                          oriented=oriented)
    torch.cuda.synchronize()
    mc_launches = {"fdf_fast_dense_tiles": fast_cuda.LAUNCHES["dense_tiles"],
                   "fdf_fast_words_tiles": fast_cuda.LAUNCHES["words_tiles"],
                   "fdf_fast_dense": fast_cuda.LAUNCHES["dense"],
                   "fdf_extract_windows": patch_cuda.LAUNCHES["extract_windows"]}
    log(f"multi-device main path launches: {mc_launches}")
    for kname, n in mc_launches.items():
        check(n > 0, f"the multi-device main path never launched {kname}")

    for (mode, n, h) in GOLDEN_1080P:
        xy = got_lists[("1080p", NonmaxMode(mode))]
        check(len(xy) == n and hash_keypoints(xy) == h,
              f"detect_arrays_rows_sharded(1080p, {mode}, 8 shards): {len(xy)} keypoints, "
              f"hash {hash_keypoints(xy):#x}")
    for mode in modes:
        mask, score = got_dense[mode]
        check(torch.equal(mask, ref_dense[mode][0][0].bool())
              and torch.equal(score, ref_dense[mode][1][0]),
              f"detect_rows_sharded(1080p, {mode.value}) != whole-frame detect_dense")
        for size in ("4K", "8192w"):
            check(np.array_equal(got_lists[(size, mode)], ref_lists[(size, mode)]),
                  f"detect_arrays_rows_sharded({size}, {mode.value}) != detect_arrays")
        mask, score = dp.gather(got_batch[mode], dev)
        check(torch.equal(mask, ref_batch[mode][0].bool()) and torch.equal(score, ref_batch[mode][1]),
              f"detect_batch_sharded(4 shards, {mode.value}) != detect_dense of the batch")
        log(f"multi-device: {mode.value}: row-sharded 1080p (8 shards) "
            f"{len(got_lists[('1080p', mode)])} keypoints with the golden hash, "
            f"mask/score == whole frame; 4K {len(ref_lists[('4K', mode)])} and 8192w "
            f"{len(ref_lists[('8192w', mode)])} keypoints == detect_arrays; "
            f"detect_batch_sharded (16, 1080, 1920) over 4 shards == detect_dense")
    for oriented, stream in got_front.items():
        tag = "steered" if oriented else "plain"
        for i, (kps, desc, dvalid, m) in enumerate(ref_front[oriented]):
            same = (torch.equal(stream.kp_xy[i], kps.xy) and torch.equal(stream.kp_score[i], kps.score)
                    and torch.equal(stream.kp_valid[i], kps.valid)
                    and torch.equal(stream.dvalid[i], dvalid)
                    and torch.equal(stream.desc[i][dvalid], desc[dvalid]))
            if m is None:
                same = same and bool((stream.match_idx[i] == -1).all()
                                     and (stream.match_dist[i] == brief.BITS + 1).all())
            else:
                same = (same and torch.equal(stream.match_idx[i], m.idx_b)
                        and torch.equal(stream.match_dist[i], m.dist))
            check(same, f"frontend_pipelined ({tag}) != sequential front-end at frame {i}")
        pinned = match.match(stream.desc[0], stream.dvalid[0], stream.desc[1], stream.dvalid[1])
        n01 = int((pinned.idx_b >= 0).sum())
        check(n01 == MATCH_PIN[oriented], f"pipelined frames 0/1: {n01} matches, "
                                          f"pinned {MATCH_PIN[oriented]}")
        log(f"multi-device: frontend_pipelined {tag} (3 stages, 3 streams on one card), k=1000: "
            f"{BATCH} frames == sequential detect_and_describe + match; matches per frame "
            f"{(stream.match_idx >= 0).sum(-1).tolist()}; frames 0/1 match {n01} (pin)")

    # -- 3d. the tools, counted --------------------------------------------
    # Each tool's run() on the card at 2 rounds; their checks raise.
    zero_counts()
    tool_recs = {}
    for name, tool, kw in (("acceptance", acceptance, {}),
                           ("resolution_bench", resolution_bench, dict(rounds=2)),
                           ("sweep", sweep, dict(rounds=2)),
                           ("serving_bench", serving_bench, dict(rounds=2)),
                           ("frontend_bench", frontend_bench, dict(rounds=2)),
                           ("scaling_bench", scaling_bench, dict(rounds=2)),
                           ("exp_off_floor", exp_off_floor, dict(rounds=2)),
                           ("exp_off_prepack", exp_off_prepack, dict(rounds=2)),
                           ("exp_off_byteswar", exp_off_byteswar, dict(rounds=2))):
        t0 = time.perf_counter()
        tool_recs[name] = list(tool.run(device="cuda", **kw))
        check(all(r["device"] == smi for r in tool_recs[name]), f"{name}: records name another card")
        log(f"tool {name}: {len(tool_recs[name])} records in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    tool_launches = {f"fdf_off_floor_{stage}": exp_off_cuda.LAUNCHES[f"floor_{stage}"]
                     for stage in exp_off.FLOORS}
    tool_launches.update(fdf_fast_words_prepacked=exp_off_cuda.LAUNCHES["words_prepacked"],
                         fdf_swar_pred16=exp_off_cuda.LAUNCHES["pred16"],
                         fdf_swar_pred8=exp_off_cuda.LAUNCHES["pred8"])
    log(f"tools main path launches: {tool_launches}")
    for kname, n in tool_launches.items():
        check(n > 0, f"the tools never launched {kname}")

    summary = tool_recs["acceptance"][-1]
    check(summary["ok"] and summary["configs"] == 24 and not summary["failures"],
          f"acceptance: {summary}")
    res = {r["resolution"]: r for r in tool_recs["resolution_bench"]}
    check(res["1080p"]["keypoints"] == 24130, f"resolution_bench 1080p: {res['1080p']}")
    sw = {(r["threshold"], r["count"]): r for r in tool_recs["sweep"]}
    check(len(sw) == 16 and sw[(16, 9)]["keypoints"] == 6469, f"sweep t=16 n=9: {sw.get((16, 9))}")
    serving_recs = [r for r in tool_recs["serving_bench"] if r["stage"] == "serving"]
    check(len(serving_recs) == 3 and all(r["bit_exact"] for r in serving_recs),
          "serving_bench: not bit-exact at every depth")
    check(len(tool_recs["frontend_bench"]) == 12, "frontend_bench: expected 3 sizes x 4 stages")
    check([r["devices"] for r in tool_recs["scaling_bench"]] == [1, 2, 4],
          f"scaling_bench devices {[r['devices'] for r in tool_recs['scaling_bench']]}")
    check(tool_recs["exp_off_prepack"][0]["bit_exact"], "exp_off_prepack: not bit-exact")
    log(f"tools: acceptance ok, 24 configs; resolution_bench 1080p OFF "
        f"{res['1080p']['keypoints']} keypoints, ms per frame "
        + ", ".join(f"{k} {r['ms_per_frame']:.4f}" for k, r in res.items())
        + f"; sweep SA t=16 n=9 {sw[(16, 9)]['keypoints']} keypoints; serving bit-exact at "
        f"depths 0, 1, 2, 4; scaling 1/2/4 devices (one card repeated)")
    log(json.dumps({"tools_at_2_rounds": {
        "exp_off_floor": {r["stage"]: r.get("ms_per_frame") for r in tool_recs["exp_off_floor"][:-1]},
        "exp_off_prepack": {r["stage"]: r.get("ms_per_frame") for r in tool_recs["exp_off_prepack"][1:-1]},
        "exp_off_byteswar": tool_recs["exp_off_byteswar"],
        "serving_link": tool_recs["serving_bench"][0]}}))

    # -- 3e. the VO main path, counted -------------------------------------
    def vo_counts() -> dict:
        return {"fdf_fast_dense": fast_cuda.LAUNCHES["dense"],
                "fdf_extract_windows": patch_cuda.LAUNCHES["extract_windows"],
                "fdf_brief_words": brief_cuda.LAUNCHES["brief_words"]}

    vo = vo_phase(dev, zero_counts, vo_counts, max_err)
    log(json.dumps({"vo": vo}))

    # -- 4. timing at (16, 1080, 1920) -------------------------------------
    def device_ms(fn, rounds: int = 20) -> float:
        """Device ms of one call of ``fn``: its launches queued behind a device sleep."""
        return loop_ms(fn, dev, rounds=rounds, repeats=7, folded=False)

    # The FAST kernels' device time against their bounds: words and dense
    # on 1 frame, 16 (33 MB, in L2) and 64 (133 MB), tiles on one frame in
    # 8 shards (tools.fast_bench).
    fb = {(r["kernel"], r["mode"], r["at"]): r for r in fast_bench.run(device="cuda")}
    for (kname, mode_name, at), r in fb.items():
        log(f"timing {kname} {mode_name} {at}: {r['ms']:.5f} ms a call (device), bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({r['int_ops']} int ops, {r['bytes']} B, "
            f"{r['candidates']} of {r['pixels']} px past the prefilter, {r['corners']} arc-test "
            f"corners), {100 * r['share_of_bound']:.1f}% of the bound")

    imgs = torch.from_numpy(batch).to(dev)
    timing = {}
    for mode in modes:
        args = (imgs, 16, 9, mode)
        cfg = Config(16, 9, mode)
        words = fast_cuda.detect_words(*args)
        points = compact.words_to_points(words)

        def serve_batches():
            pipe = serving.DetectorPipeline(cfg, depth=2)
            for b in batches:
                pipe.submit(b)
                list(pipe.ready())
            list(pipe.drain())

        r = {
            "plain_words_ms": time_cuda(
                lambda: compact.pack_mask_words(fast.detect_dense(*args)[0]),
                repeats=5, inner=2),
            "plain_dense_ms": time_cuda(lambda: fast.detect_dense(*args), repeats=5, inner=2),
            # detect_batch_arrays end to end, host array in, lists out ...
            "e2e_ms": time_host(lambda: api.detect_batch_arrays(batch, cfg)),
            # ... and its stages besides the kernel
            "h2d_ms": time_host(lambda: torch.from_numpy(batch).to(dev)),
            "decode_ms": time_host(lambda: compact.words_to_points(words)),
            "split_ms": time_host(lambda: compact.split_frames(points, BATCH)),
            # DetectorPipeline(depth=2), per batch of a 4-batch stream
            "pipeline_ms": time_host(serve_batches, repeats=5) / len(batches),
        }
        timing[mode.value] = r
        log(f"timing {mode.value} ({BATCH}, 1080, 1920), ms per frame: "
            + ", ".join(f"{k[:-3]} {v / BATCH:.4f}" for k, v in r.items()))

    # -- 4b. front-end timing at (16, 1080, 1920), k=1000 ------------------
    kps = fe[(1000, False)][0]
    blurred = brief.box_blur5(imgs)
    # Kernel times are device times (launches queued behind a device sleep);
    # plain times are CUDA-event times of the calls as a caller makes them.
    # The descriptor kernels' device time against their bounds, and both
    # describe routes by k at three frame sizes (tools.descriptor_bench): the
    # crossover that sets brief._DENSE_K_MIN_1080P and how it scales.
    db = list(descriptor_bench.run(device="cuda"))
    dk = {(r["kernel"], r["at"]): r for r in db if "kernel" in r}
    for (kname, at), r in dk.items():
        log(f"timing {kname} {at}: {r['ms']:.5f} ms a call (device), bound {r['bound_ms']:.5f} ms "
            f"by {r['bound_by']} ({r['int_ops']} int ops, {r['bytes']} B), "
            f"{100 * r['share_of_bound']:.1f}% of the bound")
    # descriptor_bench selects the same top 1000 of the same rolled batch.
    windows_at = f"{BATCH} x 1000 keypoints, patched route"
    ft = {
        "brief_words_ms": dk[("fdf_brief_words", f"batch {BATCH}")]["ms"],
        "plain_brief_words_ms": time_cuda(lambda: brief_cuda.describe_words_plain(imgs),
                                          repeats=3, inner=1),
        "extract_windows_ms": dk[("fdf_extract_windows", windows_at)]["ms"],
        "plain_extract_windows_ms": time_cuda(
            lambda: patch_cuda.extract_windows_plain(imgs, kps.xy), repeats=5, inner=2),
        "extract_patches_ms": device_ms(lambda: patch_cuda.extract_patches(blurred, kps.xy)),
        "plain_extract_patches_ms": time_cuda(
            lambda: patch_cuda.extract_patches_plain(blurred, kps.xy), repeats=5, inner=2),
    }
    for oriented in (False, True):
        tag = "oriented" if oriented else "plain"

        def frontend(oriented=oriented, images=imgs):
            return brief.detect_and_describe_batch(images, 16, 9, 1000, oriented)

        def frontend_match(oriented=oriented):
            _, desc, dvalid = frontend(oriented)
            return match.match(desc[:-1], dvalid[:-1], desc[1:], dvalid[1:])

        ft[f"frontend_{tag}_ms"] = time_cuda(frontend)
        ft[f"frontend_{tag}_match_ms"] = time_cuda(frontend_match)
        # host array in, descriptors back on the host
        ft[f"frontend_{tag}_e2e_ms"] = time_host(
            lambda: [t.cpu() for t in frontend(images=batch)[1:]])
    log(f"timing front-end ({BATCH}, 1080, 1920), k=1000, ms per frame: "
        + ", ".join(f"{k[:-3]} {v / BATCH:.4f}" for k, v in ft.items()))

    crossover = {f"{r['height']}x{r['width']} k={r['k']}": {
        "patched_ms": r["patched_ms"], "dense_ms": r["dense_ms"], "dense_k_min": r["dense_k_min"]}
        for r in db if r.get("stage") == "describe_crossover"}
    for at, r in crossover.items():
        log(f"timing describe crossover {at}, ms per frame: patched {r['patched_ms'] / BATCH:.4f}, "
            f"dense {r['dense_ms'] / BATCH:.4f} (patched up to k={r['dense_k_min']})")
    log(json.dumps({"frontend_ms_per_batch": ft, "describe_crossover_ms_per_batch": crossover,
                    "dense_k_min_1080p": brief._DENSE_K_MIN_1080P}))

    # -- 4c. row-shard kernels and the multi-device paths, ms per frame ----
    rows8 = spatial.shard_rows(1080, 8)
    [(_, ext8, row0_8)] = spatial.shard_slabs(torch.from_numpy(g1080), [dev] * 8, rows8)
    one = torch.from_numpy(g1080)[None].to(dev)
    tiles_kw = dict(height=1080, width=1920, halo=spatial.HALO)
    tt = {}
    for mode in modes:
        a = (16, 9, mode)
        tt[mode.value] = {
            "words_tiles_ms": time_cuda(lambda: fast_cuda.detect_words_tiles(ext8, row0_8, *a, **tiles_kw)),
            "dense_tiles_ms": time_cuda(lambda: fast_cuda.detect_dense_tiles(ext8, row0_8, *a, **tiles_kw)),
            "plain_dense_tiles_ms": time_cuda(
                lambda: fast.detect_dense_tiles(ext8, row0_8.tolist(), *a, **tiles_kw),
                repeats=5, inner=2),
            "plain_words_tiles_ms": time_cuda(
                lambda: compact.pack_mask_words(
                    fast.detect_dense_tiles(ext8, row0_8.tolist(), *a, **tiles_kw)[0]),
                repeats=5, inner=2),
            "words_whole_ms": time_cuda(lambda: fast_cuda.detect_words(one, *a)),
            "dense_whole_ms": time_cuda(lambda: fast_cuda.detect_dense(one, *a)),
            "slabs_ms": time_cuda(lambda: spatial.shard_slabs(torch.from_numpy(g1080), [dev] * 8, rows8)),
        }
        log(f"timing row-shard kernels, one 1080p frame in 8 shards of {rows8} rows, {mode.value}, "
            f"ms: " + ", ".join(f"{k[:-3]} {v:.4f}" for k, v in tt[mode.value].items()))
    sp = {}
    for size, frame in (("1080p", g1080), ("4K", g4k), ("8192w", g8192)):
        for mode in modes:
            cfg = Config(16, 9, mode)
            sp[f"{size}_{mode.value}"] = {
                "sharded8_ms": time_host(lambda: spatial.detect_arrays_rows_sharded(
                    frame, 16, 9, mode, mesh=mesh8)),
                "detect_arrays_ms": time_host(lambda: api.detect_arrays(frame, cfg)),
            }
        log(f"timing detect_arrays_rows_sharded (8 shards, one card) vs detect_arrays, {size} "
            f"{frame.shape}, ms per frame: "
            + "; ".join(f"{m.value} {sp[f'{size}_{m.value}']['sharded8_ms']:.4f} vs "
                        f"{sp[f'{size}_{m.value}']['detect_arrays_ms']:.4f}" for m in modes))
    pt = {}
    for oriented in (False, True):
        tag = "steered" if oriented else "plain"
        pt[f"pipelined_{tag}_ms"] = time_host(lambda: pipeline.frontend_pipelined(
            imgs, 16, 9, 1000, mesh=pipe_mesh, oriented=oriented), repeats=5) / BATCH
        pt[f"sequential_{tag}_ms"] = time_host(lambda: sequential_frontend(oriented),
                                               repeats=5) / BATCH
    log(f"timing front-end stream ({BATCH}, 1080, 1920), k=1000, device frames in, ms per frame: "
        + ", ".join(f"{k[:-3]} {v:.4f}" for k, v in pt.items()))
    log(json.dumps({"tiles_ms_per_frame": tt, "spatial_ms_per_frame": sp,
                    "pipeline_ms_per_frame": pt}))

    # -- 4d. the experiment kernels against their plain versions, ms per call
    imgs = torch.from_numpy(batch).to(dev)
    plane = exp_off.prepack(imgs)
    prng = np.random.default_rng(0)
    preds = {"pred16": pred_planes(256, 0, 2**30), "pred8": pred_planes(128, 0, 2**30)}
    et = {}

    for stage in exp_off.FLOORS:
        et[f"floor_{stage}"] = (
            device_ms(lambda: exp_off_cuda.FLOORS[stage](imgs)),
            time_cuda(lambda: exp_off.FLOORS[stage](imgs), repeats=5, inner=2))
    # The streaming floors also at 64 frames (133 MB): the 16-frame batch
    # (33 MB) may stay in the 50 MB L2 between rounds, the 64-frame one not.
    imgs64 = imgs.repeat(4, 1, 1)
    et64 = {f"floor_{stage}": device_ms(lambda: exp_off_cuda.FLOORS[stage](imgs64))
            for stage in (exp_off.LOAD, exp_off.TRIPLE)}
    del imgs64
    log("timing streaming floors, one (64, 1080, 1920) call, ms a call (device): " + ", ".join(
        f"{k} {v:.5f}" for k, v in et64.items()))
    pp_kw = dict(height=1080, width=1920)
    et["words_prepacked"] = (
        device_ms(lambda: exp_off_cuda.words_prepacked(plane, 16, 9, **pp_kw)),
        time_cuda(lambda: exp_off.words_prepacked(plane, 16, 9, **pp_kw), repeats=3, inner=1))
    et["prepack"] = (device_ms(lambda: exp_off.prepack(imgs), rounds=5), None)
    for key, xs in preds.items():
        et[key] = (device_ms(lambda: getattr(exp_off_cuda, f"swar_{key}")(*xs)),
                   time_cuda(lambda: getattr(exp_off, f"swar_{key}")(*xs), repeats=5, inner=2))
    # Kernel times are device times (launches queued behind a device sleep);
    # plain times are CUDA-event times of the calls as a caller makes them.
    log(f"timing experiment kernels, one ({BATCH}, 1080, 1920) call (t=16, n=9), ms per frame "
        f"(kernel device time / plain): " + ", ".join(
            f"{k} {v[0] / BATCH:.5f} / {v[1] / BATCH:.4f}" if v[1] is not None
            else f"{k} {v[0] / BATCH:.5f}" for k, v in et.items() if not k.startswith("pred"))
        + f"; fdf_fast_words OFF {fb[('fdf_fast_words', 'off', f'batch {BATCH}')]['ms'] / BATCH:.5f}")
    log("timing SWAR predicate kernels, ms per call (kernel / plain): " + ", ".join(
        f"{k} {et[k][0]:.5f} / {et[k][1]:.4f}" for k in preds))

    # Bounds of this run's calls (tools._common): the least time the card
    # could take for the same work, by its bytes (each input read once,
    # each output written once, at 3.35 TB/s) or by its integer operations
    # (at 16.7 T lane-operations/s), whichever is larger.
    xy_np = kps.xy.cpu().numpy()
    # The prepacked kernel computes fdf_fast_words OFF's words: its work.
    work16 = fb[("fdf_fast_words", "off", f"batch {BATCH}")]
    bounds = {
        "brief_words": _common.brief_words_bound(BATCH, 1080, 1920),
        "extract_windows": _common.extract_windows_bound(xy_np, 1080, 1920),
        "extract_patches": _common.extract_patches_bound(xy_np, 1080, 1920),
        "words_prepacked": {**{k: work16[k] for k in ("pixels", "candidates", "corners")},
                            **_common.words_prepacked_bound(plane.numel() * plane.element_size(),
                                                            BATCH, 1080, 1920, 9, work16)},
        **{f"floor_{stage}": _common.floor_bound(stage, BATCH, 1080, 1920)
           for stage in exp_off.FLOORS},
        **{key: _common.swar_pred_bound(key, xs[0].numel()) for key, xs in preds.items()},
    }
    # No single PyTorch call computes any of these functions, so no row
    # has a library yardstick; each says why.
    no_library = {
        "fast": "no PyTorch call computes the FAST arc test, score and 3x3 strict-max nonmax",
        "brief_words": "no PyTorch call computes the blur and 256 pattern compares packed into "
                       "bits",
        "extract_windows": "no PyTorch call cuts a blurred, raw-packed window per keypoint",
        "extract_patches": "no single PyTorch call cuts a clamped (32, 128) window per keypoint",
        "floor": "no single PyTorch call packs a per-pixel predicate into 32-px words",
        "pred": "the predicate sequence is a chain of elementwise operations, not one call",
    }

    def measured(b: dict, library: str) -> dict:
        basis = f"{b['int_ops']} int ops, {b['bytes']} B"
        if "candidates" in b:
            basis += (f"; {b['pixels']} px, {b['candidates']} past the prefilter, "
                      f"{b['corners']} arc-test corners")
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "bound_basis": basis,
                "share_of_bound": None, "library_ms": None, "library_note": no_library[library]}

    rows = []
    fast_device = "device time (tools.fast_bench: loop_ms, launches queued behind a device sleep)"
    for kname, key, line, path in (
            ("fdf_fast_words", "words", 949,
             "1 per detect / detect_arrays / detect_batch_* call and DetectorPipeline batch"),
            ("fdf_fast_dense", "dense", 621,
             "1 per front-end batch, strongest-K step, data-parallel shard run, pipeline frame")):
        mt = fb[(kname, "max_threshold", f"batch {BATCH}")]
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": "feature_detector_fast_tpu_torch/csrc/fast.cu",
            "replaces": f"feature_detector_fast_tpu/ops/fast_pallas.py:{line}",
            "launches": launches[key],
            "launches_per_call": 1,
            "main_path": path,
            "max_abs_err": max_err[key],
            "ms": mt["ms"],
            "plain_ms": timing["max_threshold"][f"plain_{key}_ms"],
            **measured(mt, "fast"),
            "share_of_bound": mt["share_of_bound"],
            "timed_at": f"one ({BATCH}, 1080, 1920) call, t=16, n=9, max_threshold",
            "ms_is": fast_device,
            "ms_by_mode": {m: fb[(kname, m, f"batch {BATCH}")]["ms"] for m in MODE_NAMES},
            "bound_ms_by_mode": {m: fb[(kname, m, f"batch {BATCH}")]["bound_ms"]
                                 for m in MODE_NAMES},
            "ms_by_mode_64_frames": {m: fb[(kname, m, "batch 64")]["ms"] for m in MODE_NAMES},
            "ms_by_mode_1_frame": {m: fb[(kname, m, "batch 1")]["ms"] for m in MODE_NAMES},
            "bound_ms_by_mode_64_frames": {m: fb[(kname, m, "batch 64")]["bound_ms"]
                                           for m in MODE_NAMES},
            "plain_ms_by_mode": {m: timing[m][f"plain_{key}_ms"] for m in timing},
        })
    fe_at = f"one call at the {BATCH} x 1000 keypoints of the k=1000 front-end, ({BATCH}, 1080, 1920)"
    for kname, key, source, replaces, n, at, path in (
            ("fdf_brief_words", "brief_words", "brief.cu", "brief_pallas.py:47",
             fe_launches["fdf_brief_words"], f"one ({BATCH}, 1080, 1920) call, every pixel",
             f"1 per front-end batch on the dense route (k > {brief._DENSE_K_MIN_1080P} at "
             f"1080p, scaled by pixels); none at k=1000 on 1080p"),
            ("fdf_extract_windows", "extract_windows", "patch.cu", "patch_pallas.py:147",
             fe_launches["fdf_extract_windows"], fe_at,
             f"1 per front-end batch on the patched route (k <= {brief._DENSE_K_MIN_1080P} at "
             f"1080p, every oriented call)"),
            ("fdf_extract_patches", "extract_patches", "patch.cu", "patch_pallas.py:69",
             patches_launches, fe_at + ", on the blurred frames", "none (tests only)")):
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": f"feature_detector_fast_tpu_torch/csrc/{source}",
            "replaces": f"feature_detector_fast_tpu/ops/{replaces}",
            "launches": n,
            "launches_per_call": 1,
            "main_path": path,
            "max_abs_err": max_err[key],
            "ms": ft[f"{key}_ms"],
            "plain_ms": ft[f"plain_{key}_ms"],
            **measured(bounds[key], key),
            "timed_at": at,
            "ms_is": "device time (loop_ms, launches queued behind a device sleep)",
        })
    rows[3]["also_replaces"] = "feature_detector_fast_tpu/ops/patch_pallas.py:123"
    for row, timed in ((rows[2], ("fdf_brief_words", "batch 1")),
                       (rows[3], ("fdf_extract_windows", f"{BATCH} x 1000 keypoints, steered route"))):
        row["ms_is"] = "device time (tools.descriptor_bench: loop_ms, launches queued behind a device sleep)"
        row["also_timed"] = {"at": timed[1], "ms": dk[timed]["ms"], "bound_ms": dk[timed]["bound_ms"],
                             "share_of_bound": dk[timed]["share_of_bound"]}
    rows[4]["launches_counted_in"] = "the kernel phase (no main path runs extract_patches)"
    for kname, key, line in (("fdf_fast_dense_tiles", "dense_tiles", 647),
                             ("fdf_fast_words_tiles", "words_tiles", 1029)):
        mt = fb[(kname, "max_threshold", "8 shards")]
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": "feature_detector_fast_tpu_torch/csrc/fast.cu",
            "replaces": f"feature_detector_fast_tpu/ops/fast_pallas.py:{line}",
            "launches": mc_launches[kname],
            "launches_per_call": 1,
            "main_path": "1 per device per row-sharded call (every shard on a device in one)",
            "max_abs_err": max_err[key],
            "ms": mt["ms"],
            "plain_ms": tt["max_threshold"][f"plain_{key}_ms"],
            **measured(mt, "fast"),
            "share_of_bound": mt["share_of_bound"],
            "timed_at": f"one call over a 1080p frame in 8 shards of {rows8} rows, halo "
                        f"{spatial.HALO}, t=16, n=9, max_threshold",
            "ms_is": fast_device,
            "ms_by_mode": {m: fb[(kname, m, "8 shards")]["ms"] for m in MODE_NAMES},
            "bound_ms_by_mode": {m: fb[(kname, m, "8 shards")]["bound_ms"] for m in MODE_NAMES},
            "plain_ms_by_mode": {m: tt[m][f"plain_{key}_ms"] for m in tt},
        })
    for kname, key, replaces, body, at in (
            ("fdf_off_floor_load", "floor_load", "exp_off_floor.py:87", "k1 :81", "frames"),
            ("fdf_off_floor_triple", "floor_triple", "exp_off_floor.py:105", "k3 :97",
             "frames, span 128"),
            ("fdf_off_floor_prefilter", "floor_prefilter", "exp_off_floor.py:128", "kwin :119",
             "frames, t=16, need 2"),
            ("fdf_fast_words_prepacked", "words_prepacked", "exp_off_prepack.py:126",
             "kernel :73", "frames' prepacked plane, t=16, n=9"),
            ("fdf_swar_pred16", "pred16", "exp_off_byteswar.py:107", "k16 :60", ""),
            ("fdf_swar_pred8", "pred8", "exp_off_byteswar.py:107", "k8 :84", "")):
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": "feature_detector_fast_tpu_torch/csrc/exp_off.cu",
            "replaces": f"tools/{replaces}",
            "body": f"tools/{replaces.split(':')[0]}:{body.split(':')[1]} ({body.split()[0]})",
            "launches": tool_launches[kname],
            "launches_per_call": 1,
            "main_path": "1 per timed round of its tool (tools/exp_off_*), on no product path",
            "max_abs_err": max_err[key],
            "ms": et[key][0],
            "plain_ms": et[key][1],
            **measured(bounds[key], "pred" if key.startswith("pred") else
                       "floor" if key.startswith("floor") else "fast"),
            "timed_at": (f"one ({BATCH}, 1080, 1920) call over the {at}" if at else
                         f"one call on the tool's seeded ({64 * (256 if key == 'pred16' else 128)}"
                         f", 128) int32 planes"),
            "launches_counted_in": "the tools phase",
            "ms_is": "device time, launches queued behind a ~2 ms device sleep",
        })
        if key in et64:
            b64 = _common.floor_bound(key[len("floor_"):], 4 * BATCH, 1080, 1920)["bound_ms"]
            rows[-1].update({
                "ms_64_frames": et64[key], "bound_ms_64_frames": b64,
                "share_of_bound_64_frames": b64 / et64[key],
                "l2_note": "the 16-frame batch (33 MB) may be served from the 50 MB L2 across "
                           "rounds; the 64-frame share (133 MB) is the device-memory share"})
    for row in rows:
        if row["name"] in vo["host"]["launches_per_run"]:
            row["vo_launches_per_run"] = vo["host"]["launches_per_run"][row["name"]]
            row["vo_main_path"] = ("tools.vo_bench odometry, F=64 640x480 K=512 (patched route): "
                                   "launches a run of frontend_features")
        if row["share_of_bound"] is None:
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
        log(f"kernel {row['name']}: {row['ms']:.5f} ms, bound {row['bound_ms']:.5f} ms by "
            f"{row['bound_by']} ({row['bound_basis']}), {100 * row['share_of_bound']:.1f}% of "
            f"the bound; launches on its path {row['launches']}"
            + (f"; 64 frames {row['ms_64_frames']:.5f} ms, "
               f"{100 * row['share_of_bound_64_frames']:.1f}% of {row['bound_ms_64_frames']:.5f}"
               if "ms_64_frames" in row else ""))
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
