"""Trajectory metrics (ATE / RPE) and timing helpers (numpy).

A copy of ``feature_detector_fast_tpu.utils.metrics``, which cannot be
imported without pulling in jax through its package's ``__init__``.  The
reference's observability is keypoint counts + wall-clock prints
(SURVEY.md §5.5); the SLAM layers add trajectory accuracy metrics:
ATE (absolute trajectory error after alignment) is the acceptance metric
named in BASELINE.json.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np


def umeyama_alignment(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity/SE(3) alignment est -> gt.

    est, gt: (N, 3) matched positions.  Returns (R, t, s) minimizing
    || gt - (s R est + t) ||^2 (Umeyama 1991).
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / est.shape[0]
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1.0
    R = u @ s_fix @ vt
    if with_scale:
        var_e = (xe * xe).sum() / est.shape[0]
        s = float((d * np.diag(s_fix)).sum() / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est_positions: np.ndarray, gt_positions: np.ndarray, align: bool = True,
    with_scale: bool = False,
) -> float:
    """Absolute trajectory error (RMSE) after optional alignment.

    Monocular SLAM is scale-ambiguous, so with_scale=True is the standard
    setting for monocular evaluation (TUM benchmark convention).
    """
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if align:
        R, t, s = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err * err).sum(axis=1).mean()))


def rpe_rmse(
    est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
) -> float:
    """Relative pose error (translation RMSE) over pose pairs at fixed
    frame delta.  est_poses, gt_poses: (N, 4, 4)."""
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    errs = []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        errs.append(e[:3, 3])
    if not errs:
        raise ValueError(
            f"rpe_rmse needs at least delta+1={delta + 1} poses, got {len(est)}"
        )
    errs = np.asarray(errs)
    return float(np.sqrt((errs * errs).sum(axis=1).mean()))


class Timer:
    """Wall-clock timing context (analogue of the reference's
    Instant::now prints, main.rs:66-72)."""

    def __init__(self, name: str = "", verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"{self.name}: {self.elapsed * 1e3:.3f} ms")
        return False
