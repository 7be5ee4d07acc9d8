"""Full visual odometry: frames/s and ATE of the composed system.

Counterpart of the JAX package's ``tools/vo_bench.py`` (odometry, and
``--resident``): ``frames`` rendered 640 x 480 frames of a loop circuit
with every degradation (noise, blur, vignette, 10 interior boxes) ->
batched detect + describe (K=512) -> batched matching of consecutive pairs
-> batched essential RANSAC (256 hypotheses) with 6 fused Gauss-Newton
iterations of 12 CG steps a pair -> scale chaining -> pose graph, as
frames per second of wall clock after a warm-up run: the number a VO
deployment sees.  Host stages (scale chaining, graph assembly) run between
the device calls, so this is not a device-only number; the stage split
(``features_s``, ``frontend_s``, ``geometry_s`` and the ``geo.*`` stages of
``run_vo_matches``) attributes it.

With ``resident`` the frame stack is on the device before the timed region
(the serving pattern; the upload of a stream overlaps the previous batch).
The JAX tool's ``--loops`` runs global bundle adjustment, which the port
does not have yet; it is not offered here.

    python -m feature_detector_fast_tpu_torch.tools.vo_bench [frames] [--resident] [--device cpu]

Frames are rendered on the host (not timed) by up to 8 processes.  One
JSON object per line on stdout; diagnostics on stderr.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
import sys
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io import render
from ..models import slam
from . import _common

#: The JAX tool's scene (tools/vo_bench.py:54-57) at 640 x 480.
SCENE = dict(fx=520.0, fy=520.0, z_back=12.0, cell=0.3, n_boxes=10, noise_sigma=4.0, blur=True,
             vignette=0.25, seed=3)


def render_config(width: int = 640, height: int = 480) -> render.RenderConfig:
    return render.RenderConfig(width=width, height=height, **SCENE)


def vo_config(frames: int, camera, max_keypoints: int = 512) -> slam.VOConfig:
    """The JAX tool's VOConfig (tools/vo_bench.py:65-67)."""
    return slam.VOConfig(max_keypoints=max_keypoints, camera=camera, loop_ratio_mad_max=0.15,
                         loop_edge_weight=0.3, loop_edge_min_gap=(3 * frames) // 4)


def _render_one(args) -> np.ndarray:
    pose, cfg, k = args
    return render.render_frame(pose, cfg, frame_id=k)


def sequence(frames: int = 64, width: int = 640, height: int = 480,
             workers: Optional[int] = None) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(ground-truth world_T_cam poses, rendered u8 frames) of the tool's
    circuit, ``laps = max(1, frames // 64)``; frames render in ``workers``
    spawned processes (default: one a CPU, at most 8), each frame what
    ``render.render_sequence`` gives."""
    cfg = render_config(width, height)
    gt = render.loop_trajectory(frames, radius=2.0, laps=max(1, frames // 64))
    workers = workers or min(8, os.cpu_count() or 1)
    jobs = [(pose, cfg, k) for k, pose in enumerate(gt)]
    if workers <= 1:
        return gt, [_render_one(j) for j in jobs]
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return gt, list(pool.map(_render_one, jobs))


def run(frames: int = 64, *, device="cuda", residents: Sequence[bool] = (False, True),
        max_keypoints: int = 512,
        seq: Optional[Tuple[np.ndarray, List[np.ndarray]]] = None) -> Iterator[dict]:
    """One record per entry of ``residents``: a warm-up run, then a timed run
    of the odometry path, with frames/s, ATE (percent of the trajectory's
    length), the stage split and the dispatch counts of the odometry
    ``estimate_pairs`` (``_common.dispatch_counts``).  ``seq`` supplies
    ``sequence()``'s output, to render once for several callers."""
    dev, card = _common.start(device)
    t0 = time.perf_counter()
    gt, imgs = seq if seq is not None else sequence(frames)
    n = len(imgs)
    _common.log(f"render {n}x{imgs[0].shape[0]}x{imgs[0].shape[1]}: "
                f"{time.perf_counter() - t0:.1f}s (host, not timed)")
    traj = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    cfg = render_config(imgs[0].shape[1], imgs[0].shape[0])
    vocfg = vo_config(n, cfg.camera(), max_keypoints)
    for resident in residents:
        frames_in = imgs
        if resident:
            frames_in = torch.from_numpy(np.stack(imgs)).to(dev)
            _common.synchronize(dev)

        def run_once():
            stages = {}
            t = time.perf_counter()
            feats = slam.frontend_features(frames_in, vocfg, device=dev)
            _common.synchronize(dev)
            stages["features_s"] = time.perf_counter() - t
            t = time.perf_counter()
            pd = slam.frontend_matches(imgs, vocfg, features=feats, device=dev)
            stages["frontend_s"] = time.perf_counter() - t
            t = time.perf_counter()
            st = {}
            est = slam.run_vo_matches(pd, vocfg, stage_times=st, device=dev)
            stages["geometry_s"] = time.perf_counter() - t
            stages.update({f"geo.{k}_s": v for k, v in st.items()})
            return est, stages, pd

        t0 = time.perf_counter()
        run_once()
        _common.log(f"warm-up: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        est, stages, pd = run_once()
        total = time.perf_counter() - t0
        ate = slam.evaluate_ate(est, gt)
        batch = slam._as_pair_batch(pd)
        counts = _common.dispatch_counts(
            lambda: slam.estimate_pairs(batch, vocfg, device=dev, dtype=torch.float32), dev)
        rec = {
            "metric": f"full-VO frames/sec ({cfg.width}x{cfg.height}, K={max_keypoints}, warm)"
                      + (" [frames device-resident]" if resident else ""),
            "frames": n,
            "resident": resident,
            "frames_per_sec": n / total,
            "total_s": total,
            "ate_pct_of_trajectory": 100.0 * ate / traj,
            "poses_finite": bool(np.isfinite(est).all()),
            **stages,
            "estimate_pairs_pairs": len(pd),
            "estimate_pairs_dispatch": counts,
            "device": card,
        }
        _common.log(f"{n} frames in {total:.2f}s = {n / total:.1f} f/s "
                    f"(ate {100 * ate / traj:.2f}%){' resident' if resident else ''}")
        yield rec


def main(argv=None) -> int:
    ap = _common.parser(__doc__)
    ap.add_argument("frames", nargs="?", type=int, default=64, help="frames (default 64)")
    ap.add_argument("--resident", action="store_true",
                    help="stage the frame stack on the device before the timed region")
    args = ap.parse_args(argv)
    return _common.print_records(run(args.frames, device=args.device,
                                     residents=(args.resident,)))


if __name__ == "__main__":
    sys.exit(main())
