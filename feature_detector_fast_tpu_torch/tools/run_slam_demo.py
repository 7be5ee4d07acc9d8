"""End-to-end SLAM demo: sequence -> trajectory -> ATE.

Counterpart of the JAX package's ``tools/run_slam_demo.py``, four modes:

* ``synthetic`` (default) -- synthetic landmark correspondences on a
  ground-truth loop: geometric VO, then with one loop closure;
* ``render`` -- a rendered closed circuit (at least 16 frames, noise, blur,
  vignette, 10 interior boxes) through the whole pipeline, staged:
  odometry, then image-level loop closures, then bundle adjustment;
* ``sequence PATH`` -- a monocular dataset directory, KITTI odometry
  (``calib.txt``) or TUM (``rgb.txt``), detected from its layout; ATE where
  ground truth exists;
* ``images DIR`` -- any directory of PNG / JPEG frames (no poses, no
  calibration): per-pair match and inlier counts, no ATE.

    python -m feature_detector_fast_tpu_torch.tools.run_slam_demo [n_frames]
        [--render | --sequence PATH | --images DIR] [--max-frames N] [--device cpu]

One JSON object per stage on stdout; the card on stderr.  Times are host
wall seconds.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..io import render as renderlib
from ..models import lie, slam, twoview
from ..utils import image as imglib
from . import _common


def _synthetic(n: int, dev) -> Iterator[dict]:
    rng = np.random.default_rng(7)
    step = lie.se3_exp(torch.tensor([0.0, 0.0, 0.7, 0.0, 2 * np.pi / (n - 1), 0.0],
                                    dtype=torch.float64)).numpy()
    poses = [np.eye(4)]
    for _ in range(n - 1):
        poses.append(poses[-1] @ step)
    gt = np.stack(poses)
    # landmark observations; slot == landmark id (the identity slot mapping)
    n_pts = 5000
    lm = np.stack([rng.uniform(-6, 10, n_pts), rng.uniform(-4, 4, n_pts),
                   rng.uniform(-2, 22, n_pts)], axis=-1)

    def proj(T):
        Xc = (np.linalg.inv(T) @ np.concatenate([lm, np.ones((n_pts, 1))], axis=1).T).T[:, :3]
        vis = Xc[:, 2] > 0.5
        p = Xc[:, :2] / np.maximum(Xc[:, 2:3], 1e-9)
        vis &= (np.abs(p[:, 0]) < 0.7) & (np.abs(p[:, 1]) < 0.55)
        return p, vis

    projs = [proj(T) for T in gt]
    noise = 5e-4
    pair_data = []
    for k in range(n - 1):
        (pa, va), (pb, vb) = projs[k], projs[k + 1]
        pair_data.append((pa + rng.normal(0, noise, pa.shape) * (k > 0),
                          pb + rng.normal(0, noise, pb.shape), va & vb))
    loop = [(0, n - 1, projs[0][0], projs[n - 1][0], projs[0][1] & projs[n - 1][1])]

    t0 = time.perf_counter()
    mets = []
    est = slam.run_vo_matches(pair_data, slam.VOConfig(), metrics=mets, device=dev)
    ate = slam.evaluate_ate(est, gt)
    yield {"stage": "vo_odometry", "frames": n, "ate": ate, "sec": time.perf_counter() - t0}
    t0 = time.perf_counter()
    est_lc = slam.run_vo_matches(pair_data, slam.VOConfig(), loop_pairs=loop, metrics=mets,
                                 device=dev)
    ate_lc = slam.evaluate_ate(est_lc, gt)
    yield {"stage": "vo_loop_closure", "ate": ate_lc, "sec": time.perf_counter() - t0}
    inliers = [m["inliers"] for m in mets if not m.get("loop_closure")]
    yield {"stage": "summary", "mean_pair_inliers": int(np.mean(inliers)),
           "ate_odometry": ate, "ate_with_loop_closure": ate_lc}


def _render(n: int, dev) -> Iterator[dict]:
    """Staged image-level SLAM on a rendered circuit with a real revisit:
    odometry -> + loop closures -> + bundle adjustment, each stage scored
    against the render poses."""
    cfg = renderlib.RenderConfig(z_back=12.0, cell=0.3, n_boxes=10, noise_sigma=4.0, blur=True,
                                 vignette=0.25, seed=3)
    gt = renderlib.loop_trajectory(max(n, 16), radius=2.0)
    t0 = time.perf_counter()
    frames = renderlib.render_sequence(gt, cfg)
    yield {"stage": "render", "frames": len(frames), "size": [cfg.height, cfg.width],
           "degradations": "noise+blur+vignette", "sec": time.perf_counter() - t0}
    # loop tuning for a circuit of this length: tight ratio gate, far-revisit
    # SE(3) edges only, moderate edge weight
    vocfg = slam.VOConfig(max_keypoints=512, camera=cfg.camera(), loop_ratio_mad_max=0.15,
                          loop_edge_weight=0.3, loop_edge_min_gap=(3 * len(frames)) // 4)
    traj = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())

    t0 = time.perf_counter()
    mets = []
    est = slam.run_vo_images(frames, vocfg, metrics=mets, device=dev)
    ate = slam.evaluate_ate(est, gt)
    yield {"stage": "vo_images", "ate": ate, "trajectory_len": traj,
           "ate_pct_of_trajectory": 100 * ate / traj,
           "mean_pair_inliers": int(np.mean([m["inliers"] for m in mets])),
           "sec": time.perf_counter() - t0}
    t0 = time.perf_counter()
    mets_lc = []
    est_lc = slam.run_vo_images(frames, vocfg, loop_closure_gap=10, metrics=mets_lc, device=dev)
    ate_lc = slam.evaluate_ate(est_lc, gt)
    yield {"stage": "vo_loop_closure", "ate": ate_lc,
           "ate_pct_of_trajectory": 100 * ate_lc / traj,
           "loop_edges": sum(1 for m in mets_lc if m.get("loop_closure")),
           "sec": time.perf_counter() - t0}
    t0 = time.perf_counter()
    est_ba = slam.run_vo_images(frames, vocfg, loop_closure_gap=10, ba_refine=True, device=dev)
    ate_ba = slam.evaluate_ate(est_ba, gt)
    yield {"stage": "vo_ba_refined", "ate": ate_ba, "ate_pct_of_trajectory": 100 * ate_ba / traj,
           "sec": time.perf_counter() - t0}
    yield {"stage": "summary", "ate_odometry": ate, "ate_with_loop_closure": ate_lc,
           "ate_with_ba": ate_ba}


def _images(path: str, max_frames: int, dev) -> Iterator[dict]:
    """A plain directory of PNG / JPEG frames: grayscale, the whole pipeline,
    per-pair metrics (no poses, so no ATE).  Frames of mixed sizes are
    center-cropped to the common minimum (one batch needs one shape)."""
    paths = sorted(p for pat in ("*.png", "*.jpg", "*.jpeg", "*.PNG", "*.JPG")
                   for p in glob.glob(os.path.join(path, pat)))[:max_frames]
    if len(paths) < 2:
        yield {"error": "need >= 2 images", "path": path, "found": len(paths)}
        return
    frames = [imglib.load_luma8(p) for p in paths]
    h = min(f.shape[0] for f in frames)
    w = min(f.shape[1] for f in frames)
    frames = [np.ascontiguousarray(f[(f.shape[0] - h) // 2:(f.shape[0] - h) // 2 + h,
                                     (f.shape[1] - w) // 2:(f.shape[1] - w) // 2 + w])
              for f in frames]
    yield {"stage": "load", "format": "images", "frames": len(frames), "size": [h, w]}
    # No calibration: a generic pinhole from the image size (f ~ 0.9 w,
    # principal point at the centre), enough for relative pair metrics.
    vocfg = slam.VOConfig(max_keypoints=1024, camera=twoview.Camera(0.9 * w, 0.9 * w, w / 2.0,
                                                                    h / 2.0))
    t0 = time.perf_counter()
    mets = []
    est = slam.run_vo_images(frames, vocfg, metrics=mets, device=dev)
    pair_mets = [m for m in mets if not m.get("loop_closure")]
    for m in pair_mets:
        yield {"stage": "pair", "pair": list(m["pair"]), "matches": m["matches"],
               "inliers": m["inliers"]}
    yield {"stage": "vo_images", "frames": len(frames),
           "mean_pair_matches": int(np.mean([m["matches"] for m in pair_mets])),
           "mean_pair_inliers": int(np.mean([m["inliers"] for m in pair_mets])),
           "trajectory_frames": int(est.shape[0]), "ate": None,
           "sec": time.perf_counter() - t0}


def _sequence(path: str, max_frames: int, dev) -> Iterator[dict]:
    if os.path.exists(os.path.join(path, "calib.txt")):
        from ..io import kitti

        paths, gt, cam = kitti.load_sequence(path, max_frames=max_frames)
        fmt = "kitti"
    elif os.path.exists(os.path.join(path, "rgb.txt")):
        from ..io import tum

        paths, gt = tum.load_sequence(path, max_frames=max_frames)
        cam = twoview.Camera(525.0, 525.0, 319.5, 239.5)  # TUM freiburg defaults
        fmt = "tum"
    else:
        yield {"error": "unrecognized sequence layout", "path": path}
        return
    frames = [imglib.load_luma8(p) for p in paths]
    yield {"stage": "load", "format": fmt, "frames": len(frames), "size": list(frames[0].shape)}
    vocfg = slam.VOConfig(max_keypoints=1024, camera=cam)
    t0 = time.perf_counter()
    mets = []
    est = slam.run_vo_images(frames, vocfg, metrics=mets, device=dev)
    rec = {"stage": "vo_images", "mean_pair_inliers": int(np.mean([m["inliers"] for m in mets])),
           "sec": time.perf_counter() - t0}
    if gt is not None:
        rec["ate"] = slam.evaluate_ate(est, gt[:len(est)])
    yield rec


def run(n_frames: int = 10, *, mode: str = "synthetic", path: Optional[str] = None,
        max_frames: int = 30, device="cuda") -> Iterator[dict]:
    """The records of one mode ("synthetic", "render", "sequence" or
    "images"; the last two read ``path``), each with the card's name.  A
    record with an ``error`` key ends the run."""
    dev, card = _common.start(device)
    stages = {"synthetic": lambda: _synthetic(n_frames, dev),
              "render": lambda: _render(n_frames, dev),
              "sequence": lambda: _sequence(path, max_frames, dev),
              "images": lambda: _images(path, max_frames, dev)}
    if mode not in stages:
        raise ValueError(f"unknown mode {mode!r}; one of {sorted(stages)}")
    for rec in stages[mode]():
        yield dict(rec, device=card)


def main(argv=None) -> int:
    ap = _common.parser(__doc__)
    ap.add_argument("n_frames", nargs="?", type=int, default=10)
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--render", action="store_true",
                       help="a rendered 3-D sequence through the whole pipeline")
    group.add_argument("--sequence", metavar="PATH", help="TUM or KITTI sequence directory")
    group.add_argument("--images", metavar="DIR",
                       help="plain directory of PNG / JPEG frames (no poses, no ATE)")
    ap.add_argument("--max-frames", type=int, default=30)
    args = ap.parse_args(argv)
    mode, path = (("images", args.images) if args.images else
                  ("sequence", args.sequence) if args.sequence else
                  ("render", None) if args.render else ("synthetic", None))
    failed = False
    for rec in run(args.n_frames, mode=mode, path=path, max_frames=args.max_frames,
                   device=args.device):
        print(json.dumps(rec), flush=True)
        failed = failed or "error" in rec
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
