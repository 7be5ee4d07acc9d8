"""Stage profile of the VO geometry: where ``run_vo_matches``' time goes.

Counterpart of the JAX package's ``tools/exp_vo_stages.py`` on
``vo_bench``'s rendered 640 x 480 circuit at K=512 (the JAX tool's scene and
``VOConfig(max_keypoints=512)``):

  * ``estimate_pairs`` over every consecutive pair at the per-pair
    Gauss-Newton budgets (iterations, CG steps) (6, 12) (the default),
    (4, 8), (2, 6) and (0, 12) (no refinement), each the median (and min) of
    ``reps`` calls after a warm call, by the host clock up to a device
    synchronisation;
  * the odometry ATE (% of the trajectory) of ``run_vo_matches`` at each
    budget;
  * ``run_vo_matches`` at the default budget, timed the same way.

Each timed step also carries ``_common.dispatch_counts`` (kernels, syncs,
device ms, wall ms of one call; null on the CPU).

    python -m feature_detector_fast_tpu_torch.tools.exp_vo_stages [frames] [--device cpu]

One JSON object per line on stdout; diagnostics on stderr.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models import slam
from . import _common, vo_bench

#: (label, pair_refine_iters, pair_refine_cg) of the JAX tool
#: (tools/exp_vo_stages.py:75-76).
VARIANTS = (("refine6x12", 6, 12), ("refine4x8", 4, 8), ("refine2x6", 2, 6),
            ("norefine", 0, 12))


def run(frames: int = 64, *, device="cuda", reps: int = 3, max_keypoints: int = 512,
        seq: Optional[Tuple[np.ndarray, List[np.ndarray]]] = None) -> Iterator[dict]:
    """The records of the profile (see the module's docstring); ``seq``
    supplies ``vo_bench.sequence(frames)``'s output, to render once for
    several callers."""
    dev, card = _common.start(device)
    gt, imgs = seq if seq is not None else vo_bench.sequence(frames)
    traj = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    cam = vo_bench.render_config(imgs[0].shape[1], imgs[0].shape[0]).camera()
    base = slam.VOConfig(max_keypoints=max_keypoints, camera=cam)
    pd = slam.frontend_matches(imgs, base, device=dev)
    batch = slam._as_pair_batch(pd)

    def timed(label: str, fn: Callable) -> dict:
        fn()  # warm
        ts = []
        for _ in range(reps):
            ts.append(_common.timed_stage(fn, dev)[1])
        rec = {"stage": label, "sec": float(np.median(ts)), "min": min(ts),
               "dispatch": _common.dispatch_counts(fn, dev), "pairs": len(pd), "device": card}
        _common.log(f"{label}: {rec['sec']:.4f} s (median of {reps}), min {rec['min']:.4f} s; "
                    f"{rec['dispatch']}")
        return rec

    configs = {label: dataclasses.replace(base, pair_refine_iters=it, pair_refine_cg=cg)
               for label, it, cg in VARIANTS}
    for label, vc in configs.items():
        yield timed(f"estimate_pairs {label}",
                    lambda vc=vc: slam.estimate_pairs(batch, vc, device=dev, dtype=torch.float32))
    for label, vc in configs.items():
        t0 = time.perf_counter()
        est = slam.run_vo_matches(pd, vc, device=dev)
        ate = 100.0 * slam.evaluate_ate(est, gt) / traj
        _common.log(f"odometry_ate {label}: {ate:.3f}%")
        yield {"stage": f"odometry_ate {label}", "ate_pct": ate,
               "sec": time.perf_counter() - t0, "device": card}
    yield timed("run_vo_matches (default)", lambda: slam.run_vo_matches(pd, base, device=dev))


def main(argv=None) -> int:
    ap = _common.parser(__doc__)
    ap.add_argument("frames", nargs="?", type=int, default=64, help="frames (default 64)")
    args = ap.parse_args(argv)
    return _common.print_records(run(args.frames, device=args.device))


if __name__ == "__main__":
    sys.exit(main())
