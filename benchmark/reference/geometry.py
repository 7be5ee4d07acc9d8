"""Geometry of the VO cells, in NumPy float64: the errors of a trajectory
and of the two-view estimates against the poses the frames were rendered
from, and the odometry chain worked out again from the pair estimates.

* ATE: positions aligned to the ground truth by the least-squares similarity
  (Umeyama 1991, with scale: monocular scale is unobservable), RMSE of what
  is left, as a percentage of the ground-truth path length.
* Two-view: an estimate of pair (k, k+1) states x_b = R x_a + t, so R should
  be R_b^T R_a of the world_T_cam ground truth and t point along
  R_b^T (o_a - o_b).  The errors are angles in degrees.
"""

from __future__ import annotations

import numpy as np


def path_length(gt: np.ndarray) -> float:
    return float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())


def ate_pct(est: np.ndarray, gt: np.ndarray) -> float:
    """Scale-aligned ATE RMSE of (F, 4, 4) world_T_cam ``est`` against
    ``gt``, in percent of the ground truth's path; inf if ``est`` is not
    finite."""
    e = np.asarray(est, np.float64)[:, :3, 3]
    g = np.asarray(gt, np.float64)[:, :3, 3]
    if not np.isfinite(e).all():
        return float("inf")
    mu_e, mu_g = e.mean(0), g.mean(0)
    xe, xg = e - mu_e, g - mu_g
    u, d, vt = np.linalg.svd(xg.T @ xe / len(e))
    fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        fix[2, 2] = -1.0
    rot = u @ fix @ vt
    scale = float((d * np.diag(fix)).sum() / max((xe * xe).sum() / len(e), 1e-12))
    aligned = scale * xe @ rot.T + mu_g
    rmse = float(np.sqrt(((aligned - g) ** 2).sum(1).mean()))
    return 100.0 * rmse / path_length(gt)


def _angle_deg(cos: np.ndarray) -> np.ndarray:
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def pair_errors(R: np.ndarray, t_unit: np.ndarray, gt: np.ndarray):
    """(rotation error, translation-direction error) in degrees, one each of
    the P = F - 1 consecutive pairs, of estimates (P, 3, 3), (P, 3)."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t_unit, np.float64)
    ra, rb = gt[:-1, :3, :3], gt[1:, :3, :3]
    oa, ob = gt[:-1, :3, 3], gt[1:, :3, 3]
    r_gt = np.einsum("pji,pjk->pik", rb, ra)
    t_gt = np.einsum("pji,pj->pi", rb, oa - ob)
    rot = _angle_deg((np.einsum("pij,pij->p", R, r_gt) - 1.0) / 2.0)
    cos_t = np.einsum("pi,pi->p", t, t_gt) / np.maximum(
        np.linalg.norm(t, axis=1) * np.linalg.norm(t_gt, axis=1), 1e-300)
    rot = np.where(np.isfinite(rot), rot, 180.0)
    trans = np.where(np.isfinite(cos_t), _angle_deg(cos_t), 180.0)
    return rot, trans


def ray_depths(R: np.ndarray, t: np.ndarray, pa: np.ndarray, pb: np.ndarray):
    """Depths (za, zb) of each correspondence along its two rays: the least
    squares solution of za R qa - zb qb + t = 0, qa = [pa, 1], qb = [pb, 1]."""
    u = np.concatenate([pa, np.ones((len(pa), 1))], 1) @ np.asarray(R, np.float64).T
    v = np.concatenate([pb, np.ones((len(pb), 1))], 1)
    uu, vv, uv = (u * u).sum(1), (v * v).sum(1), (u * v).sum(1)
    ut, vt = u @ t, v @ t
    den = uu * vv - uv * uv
    den = np.where(np.abs(den) < 1e-12, 1e-12, den)
    return (uv * vt - ut * vv) / den, (uu * vt - uv * ut) / den


def chain(R: np.ndarray, t_unit: np.ndarray, inl: np.ndarray, pa: np.ndarray, pb: np.ndarray,
          idx_b: np.ndarray) -> np.ndarray:
    """(P + 1, 4, 4) world_T_cam poses of consecutive pair estimates x_b =
    R x_a + s t_unit chained from the identity.  Pair k's scale s_k links it
    to pair k - 1 through the frame they share: the median, over the
    correspondences that are inliers of both (pair k - 1's slot i is frame-k
    slot ``idx_b[k - 1, i]``) and in front of both cameras, of the ratio of
    that point's depth in frame k by the two pairs; the first pair's scale
    is 1.  ``inl`` (P, K) are the pairs' inliers, ``pa``, ``pb`` (P, K, 2)
    the normalized correspondences, ``idx_b`` (P, K) the matched slots (-1
    where none)."""
    p, k_cap = inl.shape
    za, zb = zip(*(ray_depths(R[k], t_unit[k], pa[k], pb[k]) for k in range(p)))
    scale = 1.0
    poses = [np.eye(4)]
    for k in range(p):
        if k:
            prev = inl[k - 1] & (idx_b[k - 1] >= 0) & (zb[k - 1] > 1e-6)
            shared = np.full(k_cap, np.nan)
            shared[idx_b[k - 1, prev]] = zb[k - 1][prev]
            cur = inl[k] & (za[k] > 1e-6)
            d_prev, d_cur = shared[cur], za[k][cur]
            ok = np.isfinite(d_prev) & (d_prev > 1e-6)
            scale *= float(np.median(d_prev[ok] / d_cur[ok])) if ok.any() else 1.0
        cam_b_T_cam_a = np.eye(4)
        cam_b_T_cam_a[:3, :3] = R[k]
        cam_b_T_cam_a[:3, 3] = t_unit[k] * scale
        poses.append(poses[-1] @ np.linalg.inv(cam_b_T_cam_a))
    return np.stack(poses)


def link_gaps(est: np.ndarray, R: np.ndarray, t_unit: np.ndarray, ref: np.ndarray):
    """How the links of trajectory ``est`` (F, 4, 4) depart from the pair
    estimates (R, t_unit) they were chained from and from the reference
    chain ``ref``: per pair k, the link cam_b_T_cam_a = est[k+1]^-1 est[k]
    has a pose gap (the Frobenius distance of its rotation to R_k plus that
    of its translation's direction to t_unit_k) and, from the second pair
    on, a scale gap (the change of log scale from the previous link, less
    the reference chain's).  Returns (pose gaps (P,), scale gaps (P - 1,));
    inf where ``est`` is not finite."""
    est = np.asarray(est, np.float64)
    p = len(R)
    if not np.isfinite(est).all():
        return np.full(p, np.inf), np.full(p - 1, np.inf)
    link = np.linalg.inv(est[1:]) @ est[:-1]
    ref_link = np.linalg.inv(ref[1:]) @ ref[:-1]
    s = np.linalg.norm(link[:, :3, 3], axis=1)
    s_ref = np.linalg.norm(ref_link[:, :3, 3], axis=1)
    pose = (np.linalg.norm(link[:, :3, :3] - R, axis=(1, 2))
            + np.linalg.norm(link[:, :3, 3] / np.maximum(s, 1e-300)[:, None] - t_unit, axis=1))
    scale = np.abs(np.diff(np.log(s)) - np.diff(np.log(s_ref)))
    return pose, scale
