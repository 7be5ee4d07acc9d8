"""Full visual odometry: frames/s and ATE of the composed system.

Counterpart of the JAX package's ``tools/vo_bench.py``: ``frames``
rendered 640 x 480 frames of a loop circuit with every degradation (noise,
blur, vignette, 10 interior boxes) -> batched detect + describe (K=512) ->
batched matching of consecutive pairs -> batched essential RANSAC (256
hypotheses) with 6 fused Gauss-Newton iterations of 12 CG steps a pair ->
scale chaining -> pose graph, as frames per second of wall clock after a
warm-up run: the number a VO deployment sees.  With ``--loops``, loop
proposal (gap 10, the 8 most signature-similar partners a frame), the loop
stages and bundle adjustment (rotation averaging, then 2 rounds of gated
global Huber BA, 20 iterations of 40 CG steps) run too.  Host stages (scale
chaining, graph assembly, union-find tracks, triangulation) run between the
device calls, so this is not a device-only number; the stage split
(``features_s``, ``frontend_s``, ``loop_propose_s``, ``geometry_s`` and the
``geo.*`` stages of ``run_vo_matches`` and ``refine_with_ba``) attributes
it.

With ``resident`` the frame stack is on the device before the timed region
(the serving pattern; the upload of a stream overlaps the previous batch).

    python -m feature_detector_fast_tpu_torch.tools.vo_bench [frames] [--loops] [--resident]
        [--device cpu]

Frames are rendered on the host (not timed) by up to 8 processes.  One
JSON object per line on stdout; diagnostics on stderr.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
import sys
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

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


def render_async(frames: int = 64, width: int = 640, height: int = 480,
                 workers: Optional[int] = None, laps: Optional[int] = None
                 ) -> Tuple[np.ndarray, Callable[[], List[np.ndarray]]]:
    """Start rendering :func:`sequence`'s circuit: returns (the ground-truth
    poses, ``wait``).  The frames render in ``workers`` spawned processes
    while the caller goes on; ``wait()`` returns them and stops the
    processes.  With one worker, ``wait()`` renders in this process."""
    cfg = render_config(width, height)
    laps = laps or max(1, frames // 64)
    gt = render.loop_trajectory(frames, radius=2.0, laps=laps)
    workers = workers or min(8, os.cpu_count() or 1)
    jobs = [(pose, cfg, k) for k, pose in enumerate(gt)]
    if workers <= 1:
        return gt, lambda: [_render_one(j) for j in jobs]
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    results = pool.map(_render_one, jobs)

    def wait() -> List[np.ndarray]:
        try:
            return list(results)
        finally:
            pool.shutdown()

    return gt, wait


def sequence(frames: int = 64, width: int = 640, height: int = 480,
             workers: Optional[int] = None, laps: Optional[int] = None
             ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(ground-truth world_T_cam poses, rendered u8 frames) of the tool's
    circuit, by default ``laps = max(1, frames // 64)``; frames render in
    ``workers`` spawned processes (default: one a CPU, at most 8), each frame
    what ``render.render_sequence`` gives.  At 64 frames a lap, the first n
    frames of ``sequence(m)`` are ``sequence(n)`` for n <= m (the camera's
    angle 2 pi laps k / frames and the noise seed k of frame k are the same)."""
    gt, wait = render_async(frames, width, height, workers, laps)
    return gt, wait()


def run(frames: int = 64, *, device="cuda", residents: Sequence[bool] = (False, True),
        max_keypoints: int = 512, loops: bool = False,
        seq: Optional[Tuple[np.ndarray, List[np.ndarray]]] = None) -> Iterator[dict]:
    """One record per entry of ``residents``: a warm-up run, then a timed run
    of the odometry path, or with ``loops`` of loops + bundle adjustment,
    with frames/s, ATE (percent of the trajectory's length), the stage split
    and the dispatch counts (``_common.dispatch_counts``) of the odometry
    ``estimate_pairs`` and, with ``loops``, of one ``refine_with_ba`` on the
    timed run's inputs, beside the ATE of its pose graph (the loop stage).
    ``seq`` supplies ``sequence()``'s output, to render once for several
    callers."""
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
            loop_pairs = None
            if loops:
                t = time.perf_counter()
                loop_pairs = slam.propose_loop_closures(imgs, vocfg, gap=10, top_k=8,
                                                        features=feats, device=dev)
                stages["loop_propose_s"] = time.perf_counter() - t
            t = time.perf_counter()
            st, internals = {}, {}
            est = slam.run_vo_matches(pd, vocfg, loop_pairs=loop_pairs, ba_refine=loops,
                                      _internals=internals, stage_times=st, device=dev)
            stages["geometry_s"] = time.perf_counter() - t
            stages.update({f"geo.{k}_s": v for k, v in st.items()})
            return est, stages, pd, loop_pairs, internals

        t0 = time.perf_counter()
        run_once()
        _common.log(f"warm-up: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        est, stages, pd, loop_pairs, internals = run_once()
        total = time.perf_counter() - t0
        ate = slam.evaluate_ate(est, gt)
        batch = slam._as_pair_batch(pd)
        counts = _common.dispatch_counts(
            lambda: slam.estimate_pairs(batch, vocfg, device=dev, dtype=torch.float32), dev)
        rec = {
            "metric": f"full-VO frames/sec ({cfg.width}x{cfg.height}, K={max_keypoints}, warm)"
                      + (" with loop closure + BA" if loops else "")
                      + (" [frames device-resident]" if resident else ""),
            "frames": n,
            "resident": resident,
            "loops": loops,
            "frames_per_sec": n / total,
            "total_s": total,
            "ate_pct_of_trajectory": 100.0 * ate / traj,
            "poses_finite": bool(np.isfinite(est).all()),
            **stages,
            "estimate_pairs_pairs": len(pd),
            "estimate_pairs_dispatch": counts,
            "device": card,
        }
        if loops:
            links = internals["loop_links"]
            rec.update({
                "loops_proposed": len(loop_pairs),
                "loop_links": len(links),
                "loop_stage_ate_pct_of_trajectory":
                    100.0 * slam.evaluate_ate(internals["graph_poses"], gt) / traj,
                "refine_with_ba_dispatch": _common.dispatch_counts(
                    lambda: slam.refine_with_ba(
                        internals["graph_poses"], internals["batch"], internals["est"],
                        loop_links=links or None, graph_edges=internals["rot_edges"],
                        device=dev), dev),
            })
        _common.log(f"{n} frames in {total:.2f}s = {n / total:.1f} f/s "
                    f"(ate {100 * ate / traj:.2f}%){' loops + BA' if loops else ''}"
                    f"{' resident' if resident else ''}")
        yield rec


def main(argv=None) -> int:
    ap = _common.parser(__doc__)
    ap.add_argument("frames", nargs="?", type=int, default=64, help="frames (default 64)")
    ap.add_argument("--resident", action="store_true",
                    help="stage the frame stack on the device before the timed region")
    ap.add_argument("--loops", action="store_true",
                    help="loop proposal, loop closure and bundle adjustment too")
    args = ap.parse_args(argv)
    return _common.print_records(run(args.frames, device=args.device,
                                     residents=(args.resident,), loops=args.loops))


if __name__ == "__main__":
    sys.exit(main())
