"""Monocular odometry of whole sequences through the port's SLAM entry points.

Set-up renders one circuit on the device (``data.render``), from the
configuration's room and the run's seed (the noise field and the RANSAC
draws), and keeps its frames on the host.  A request runs one whole
sequence in ``tools/vo_bench``'s call order: ``slam.frontend_features`` and
``frontend_matches``, then ``run_vo_matches`` (no loops, no bundle
adjustment) with ``stage_times``.

The answers kept from the window are compared with the plain reference,
each number the worst over the kept sequences:
  * exactly (limit 0), the front-end's keypoints and descriptors
    (``frontend_mismatch``) and the consecutive pairs' matches
    (``match_mismatch``), against ``reference.brief`` run on the same frames;
  * the trajectory link by link (``reference.geometry.link_gaps``): each
    link's rotation and direction against the pair estimate it was chained
    from (``link_pose_gap``, the widest), and its change of scale against
    the chain that the reference works out again in float64 from the pair
    estimates, their inliers and the reference correspondences
    (``link_scale_gap``, the median over the links).
The pairs' errors against the poses the frames were rendered from, and the
ATE, are reported on stderr and not compared: no control or fault that was
read separates them from sound runs (see PERF.md).
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from benchmark.data import render
from benchmark.reference import brief as ref_brief
from benchmark.reference import geometry as ref_geo


class Sequences:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: torch.device,
                 limits: Dict[str, float]):
        t_import = time.perf_counter()
        from feature_detector_fast_tpu_torch.models import slam, twoview

        self.slam = slam
        self.device = device
        self.limits = limits
        scene = config["scene"]
        n = int(config["frames"])
        t0 = time.perf_counter()
        self.gt, frames = render.render_circuit(scene, n, int(seed) % (1 << 31), device)
        self.frames_dev = frames
        self.frames = list(frames.cpu().numpy())
        self.focal = (scene["fx"], scene["fy"])
        self.centre = (scene["width"] / 2.0 - 0.5, scene["height"] / 2.0 - 0.5)
        vo = config["vo"]
        self.vocfg = slam.VOConfig(
            threshold=int(vo["threshold"]), count=int(vo["count"]),
            max_keypoints=int(vo["max_keypoints"]),
            camera=twoview.Camera(*self.focal, *self.centre),
            ransac_hypotheses=int(vo["ransac_hypotheses"]),
            pair_refine_iters=int(vo["pair_refine_iters"]),
            pair_refine_cg=int(vo["pair_refine_cg"]), seed=int(seed) % (1 << 31))
        self.frames_per_request = n
        self.spans: Dict[str, float] = {}
        t1 = time.perf_counter()
        self.request()  # every shape of the sequence once
        self.spans.clear()
        print(f"set-up: import {t0 - t_import:.3f} s, render {t1 - t0:.3f} s, "
              f"warm-up sequence {time.perf_counter() - t1:.3f} s", file=sys.stderr)

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def request(self):
        slam, cfg, dev = self.slam, self.vocfg, self.device
        with self._span("frontend"):
            feats = slam.frontend_features(self.frames, cfg, device=dev)
            pairs = slam.frontend_matches(self.frames, cfg, features=feats, device=dev)
        stages, internals = {}, {}
        with self._span("vo_matches"):
            poses = slam.run_vo_matches(pairs, cfg, _internals=internals, stage_times=stages,
                                        device=dev)
        for k, v in stages.items():
            self.spans[f"stage.{k}"] = self.spans.get(f"stage.{k}", 0.0) + v
        est = internals["est"]
        return {"poses": poses, "feats": feats, "pairs": [(p[2], p[3]) for p in pairs],
                "R": est.R, "t": est.t_unit, "inl": est.inl}

    def release(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _normalized(self, xy: np.ndarray) -> np.ndarray:
        return (xy.astype(np.float64) - self.centre) / self.focal

    def check(self, kept) -> Tuple[List[Tuple[str, float, float]], int]:
        vo = self.vocfg
        xy, _, desc, dvalid = ref_brief.features(self.frames_dev, vo.threshold, vo.count,
                                                 vo.max_keypoints)
        n = len(self.frames)
        odo = [ref_brief.match(desc[k], dvalid[k], desc[k + 1], dvalid[k + 1])
               for k in range(n - 1)]
        # the reference correspondences of each pair, normalized, in float64
        xy_h = xy.cpu().numpy()
        idx = np.stack([r.cpu().numpy() for r in odo])
        ok = idx >= 0
        pa = np.stack([self._normalized(xy_h[k]) for k in range(n - 1)])
        pb = np.stack([self._normalized(xy_h[k + 1][np.maximum(idx[k], 0)])
                       for k in range(n - 1)])
        front = match = failed = 0
        worst: Dict[str, float] = {}
        for _, a in kept:
            pxy, pdesc, pvalid = (t.to(self.device) for t in a["feats"])
            bad = int((pxy != xy).any(-1).sum()) + int((pvalid != dvalid).sum())
            bad += int(((pdesc != desc).any(-1) & pvalid & dvalid).sum())
            m = 0
            for (pok, pidx), r in zip(a["pairs"], odo):
                m += int((torch.as_tensor(pidx.astype(np.int64), device=self.device) != r).sum())
                m += int((torch.as_tensor(pok, device=self.device) != (r >= 0)).sum())
            g = self.geometry(a, pa, pb, ok, idx)
            print("geometry " + " ".join(f"{k} {v:.6g}" for k, v in g.items()), file=sys.stderr)
            for k, v in g.items():
                worst[k] = max(worst.get(k, v), v)
            front, match = front + bad, match + m
            failed += int(bad + m > 0 or any(g[k] > lim for k, lim in self.limits.items()
                                             if k in g))
        print(f"checked {len(kept)} sequences of {n} frames against the plain front-end, the "
              f"rendered poses and the float64 chain", file=sys.stderr)
        worst.update(frontend_mismatch=front, match_mismatch=match)
        return [(k, worst[k], lim) for k, lim in self.limits.items()], failed

    def geometry(self, answer, pa, pb, ok, idx) -> Dict[str, float]:
        """One sequence's link gaps to the float64 chain of its pair
        estimates, and, reported only, the pairs' median rotation and
        direction errors against the rendered poses and the ATE."""
        R, t = np.asarray(answer["R"], np.float64), np.asarray(answer["t"], np.float64)
        ref = ref_geo.chain(R, t, answer["inl"] & ok, pa, pb, idx)
        pose_gap, scale_gap = ref_geo.link_gaps(answer["poses"], R, t, ref)
        rot, direction = ref_geo.pair_errors(R, t, self.gt)
        return {"link_pose_gap": float(pose_gap.max()),
                "link_scale_gap": float(np.median(scale_gap)),
                "pair_rot_median_deg": float(np.median(rot)),
                "pair_dir_median_deg": float(np.median(direction)),
                "ate_pct": ref_geo.ate_pct(answer["poses"], self.gt)}

    def controls(self) -> Dict[str, Callable]:
        """The control and the planted faults by name, each a context
        manager under which requests give their answers: ``nonstrict``, the
        front-end's exact semantics broken (the plain FAST with >= t in
        place of the program's detector and descriptors, which the program
        matches); ``scales_unchanged``, the scale chain left at its start
        (every pair at scale 1); ``pose_turned``, the pose graph's answer
        altered where it is produced (its middle pose turned by a
        degree)."""
        return {"nonstrict": self._nonstrict, "scales_unchanged": self._scales_unchanged,
                "pose_turned": self._pose_turned}

    def _nonstrict(self):
        vo = self.vocfg
        xy, _, desc, dvalid = ref_brief.features(self.frames_dev, vo.threshold, vo.count,
                                                 vo.max_keypoints, strict=False)
        return _patched(self.slam, "frontend_features",
                        lambda real: lambda *a, **k: (xy, desc, dvalid))

    def _pose_turned(self):
        from feature_detector_fast_tpu_torch.models import posegraph

        c, s = np.cos(np.radians(1.0)), np.sin(np.radians(1.0))
        turn = torch.tensor([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])

        def wrap(real):
            def optimize(*a, **k):
                poses, costs = real(*a, **k)
                poses = poses.clone()
                poses[len(poses) // 2, :3, :3] = turn.to(poses) @ poses[len(poses) // 2, :3, :3]
                return poses, costs
            return optimize
        return _patched(posegraph, "optimize", wrap)

    def _scales_unchanged(self):
        return _patched(self.slam, "_chain_scales", lambda real: lambda est, idx_b: np.ones(
            est.inl.shape[0]))


@contextlib.contextmanager
def _patched(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(module.name)`` while open."""
    saved = getattr(module, name)
    setattr(module, name, wrap(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def make(config, traffic, seed, device, limits):
    return Sequences(config, traffic, seed, device, limits)
