"""Monocular visual odometry and SLAM: odometry, loop closure, bundle adjustment.

Counterpart of ``feature_detector_fast_tpu.models.slam``::

    frames -> detect + describe (FAST + BRIEF, one batched call)
           -> match consecutive pairs (one batched call)
           -> essential RANSAC + pose recovery + ray depths + per-pair
              Gauss-Newton refinement for all P pairs at once
           -> median-depth scale chaining between consecutive pairs
           -> loop pairs: the same batched estimate, zero-parallax revisits,
              a linear scale-drift solve, robust loop edges
           -> pose-graph optimization
           -> optional bundle adjustment (``refine_with_ba``): multi-frame
              tracks by union-find over (frame, slot) keys, loop links
              included; with loops, rotation averaging then gated global
              Huber BA, else sliding-window BA (>= 16 frames) or one global
              BA

Every per-pair estimate of a sequence is one set of batched tensor
operations over (P, ...) and (P, H, ...) shapes (``estimate_pairs``): no
Python loop over pairs or hypotheses, one host fetch at the end.
Cross-pair linking (scale chaining, loop scale, drift) is exact integer
slot indexing on the host: correspondence slot i of pair k is keypoint slot
i of frame k, and ``idx_b[k, i]`` is its matched keypoint slot of frame
k+1.

The RANSAC draws come from a CPU ``torch.Generator`` seeded by
``config.seed + seed_offset`` (``ransac_draws``) and are moved to the
device, so the card and the CPU sample the same hypotheses.

Entry points take ``device`` ("cuda", the default, raises without CUDA;
or "cpu") and ``dtype`` (float32 by default; float64 for parity runs).
Track building and triangulation stay on the host in numpy, as in the JAX
package; the bundle-adjustment solves run on ``device``.

Monocular scale is unobservable; trajectories are scored with scale-aligned
ATE (``evaluate_ate``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import _device
from ..utils import tracing
from ..utils.metrics import ate_rmse
from ..utils.precision import matmul_highest
from . import ba as ba_lib
from . import brief, match, posegraph, twoview


@dataclasses.dataclass(frozen=True)
class VOConfig:
    threshold: int = 16
    count: int = 9
    max_keypoints: int = 512
    camera: twoview.Camera = twoview.Camera(300.0, 300.0, 160.0, 120.0)
    ransac_hypotheses: int = 256
    ransac_threshold: float = 1e-4
    pose_graph_iters: int = 10
    #: Geman-McClure scale (se3-log units) of pose-graph edges when loop
    #: closures are present: a confidently wrong loop hypothesis must lose
    #: its influence past this residual norm.
    loop_robust_delta: float = 0.25
    #: Pose-graph iterations when loop closures are present.
    loop_pose_graph_iters: int = 40
    #: Largest median absolute deviation of a loop pair's log depth ratios
    #: before the hypothesis is dropped.
    loop_ratio_mad_max: float = 0.3
    #: Pose-graph weight of loop edges relative to odometry edges.
    loop_edge_weight: float = 1.0
    #: Loop pairs closer than this many frames give only their scale-drift
    #: observation, not an SE(3) edge.
    loop_edge_min_gap: int = 0
    #: Median rotation-compensated disparity below which a loop pair is a
    #: zero-parallax revisit: its SE(3) measurement is [R | 0].
    revisit_disparity_max: float = 4e-3
    #: Per-pair Gauss-Newton refinement iterations (a two-camera bundle
    #: adjustment in the same batched estimate; 0 disables) and CG steps.
    pair_refine_iters: int = 6
    pair_refine_cg: int = 12
    seed: int = 0
    #: > 1 detects and describes over a dyadic pyramid
    #: (``pyramid.detect_and_describe_multiscale``), max_keypoints //
    #: pyramid_levels slots a level.
    pyramid_levels: int = 1


def vo_config_from(obj) -> VOConfig:
    """The port's VOConfig from any object with the reference's fields (a
    JAX ``VOConfig``) or a dict; fields it lacks keep their defaults."""
    get = (obj.get if isinstance(obj, dict)
           else lambda k, default=None: getattr(obj, k, default))
    kw = {}
    for f in dataclasses.fields(VOConfig):
        v = get(f.name, None)
        if v is not None:
            kw[f.name] = twoview.camera_from(v) if f.name == "camera" else type(f.default)(v)
    return VOConfig(**kw)


class PairBatch(NamedTuple):
    """Fixed-capacity correspondence batch for P frame pairs: slot i of pair
    k is keypoint slot i of the pair's first frame; ``idx_b[k, i]`` is the
    matched keypoint slot of its second frame (-1 where unmatched).
    Synthetic inputs whose slot is a landmark id use the identity."""

    pa: np.ndarray  # (P, K, 2) normalized coordinates in the first frame
    pb: np.ndarray  # (P, K, 2) normalized coordinates in the second frame
    valid: np.ndarray  # (P, K) bool
    idx_b: np.ndarray  # (P, K) int32 second-frame keypoint slot, -1 invalid


class PairEstimates(NamedTuple):
    """Per-pair geometry of one batched estimate (host numpy).  Convention:
    x_b = R x_a + t_unit, so cam_b_T_cam_a = [R | t_unit * scale] once a
    scale is chained on."""

    R: np.ndarray  # (P, 3, 3)
    t_unit: np.ndarray  # (P, 3)
    inl: np.ndarray  # (P, K) bool RANSAC inliers
    depths_a: np.ndarray  # (P, K) depth in the first frame
    depths_b: np.ndarray  # (P, K) the same points' depth in the second frame


def _as_pair_batch(pair_data: Sequence[Tuple[np.ndarray, ...]],
                   slots: Optional[int] = None) -> PairBatch:
    """A list of (pa, pb, valid[, idx_b]) tuples as a PairBatch padded to
    its longest entry, or to ``slots`` with longer entries truncated; a
    missing idx_b is the identity slot mapping."""
    kmax = slots or max(np.asarray(t[0]).shape[0] for t in pair_data)
    p = len(pair_data)
    pa = np.zeros((p, kmax, 2), np.asarray(pair_data[0][0]).dtype)
    pb = np.zeros_like(pa)
    valid = np.zeros((p, kmax), bool)
    idx_b = np.full((p, kmax), -1, np.int32)
    for k, entry in enumerate(pair_data):
        a, b, v = (np.asarray(x)[:kmax] for x in entry[:3])
        n = a.shape[0]
        pa[k, :n] = a
        pb[k, :n] = b
        valid[k, :n] = v
        if len(entry) > 3:
            idx_b[k, :n] = np.asarray(entry[3], np.int32)[:n]
        else:
            idx_b[k, :n] = np.arange(n, dtype=np.int32)
        idx_b[k, :n] = np.where(valid[k, :n], idx_b[k, :n], -1)
    return PairBatch(pa, pb, valid, idx_b)


def ransac_draws(seed: int, pairs: int, hypotheses: int, slots: int) -> torch.Tensor:
    """(pairs, hypotheses, slots) float32 uniform draws on the CPU from a
    ``torch.Generator`` seeded by ``seed``: the same draws whatever device
    the estimate runs on."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.rand((pairs, hypotheses, slots), generator=gen)


@matmul_highest
def _estimate_pairs_device(pa, pb, valid, draws, threshold, refine_iters=0, refine_cg=12):
    """Essential RANSAC + pose recovery + ray depths, plus with
    ``refine_iters`` > 0 a two-camera Gauss-Newton reprojection refinement,
    for a (P, K, 2) batch: the whole sequence's two-view geometry as one
    set of batched operations."""
    E, inl = twoview.ransac_essential(pa, pb, valid, draws, threshold)
    R, t, _ = twoview.recover_pose(E, pa, pb, inl)
    za, zb = twoview.ray_depths(R, t, pa, pb)
    if refine_iters > 0:
        # Two-camera BA on the RANSAC inliers: world = camera a; camera b's
        # 6 dof and the inlier structure are free.  Invalid slots get a
        # benign placeholder point; their residuals are masked.
        p, k = pa.shape[:2]
        X = twoview._homogeneous(pa) * za[..., None]  # frame-a (world) landmarks
        ok = inl & (za > 1e-6) & torch.isfinite(za)
        Xs = torch.where(ok[..., None], X, torch.eye(3, dtype=X.dtype, device=X.device)[2])
        eye = torch.eye(4, dtype=pa.dtype, device=pa.device).expand(p, 4, 4)
        Tb = eye.clone()
        Tb[:, :3, :3] = R
        Tb[:, :3, 3] = t
        idx = torch.arange(k, device=pa.device)
        prob = ba_lib.BAProblem(
            poses=torch.stack([eye, Tb], dim=1),
            points=Xs,
            obs_cam=torch.cat([torch.zeros_like(idx), torch.ones_like(idx)]),
            obs_lm=torch.cat([idx, idx]),
            obs_uv=torch.cat([pa, pb], dim=1),
            obs_valid=torch.cat([ok, ok], dim=1),
            n_fixed_cams=1,
        )
        newp, _, _ = ba_lib.optimize(prob, refine_iters, refine_cg, 1e-6, 0.0)
        R = newp[:, 1, :3, :3]
        t = newp[:, 1, :3, 3]
        t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
        za, zb = twoview.ray_depths(R, t, pa, pb)
    return R, t, inl, za, zb


def _put(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` on ``dev`` in ``dtype``: a tensor as it is, host values through
    ``np.asarray`` (a list of floats stays float64 up to the cast)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=dev, dtype=dtype)


def estimate_pairs(batch: PairBatch, config: VOConfig, seed_offset: int = 0,
                   draws: Optional[torch.Tensor] = None, *, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> PairEstimates:
    """Batched two-view estimation of all P pairs, one host fetch.

    ``draws`` (P, H, K) overrides the RANSAC draws (default
    ``ransac_draws(config.seed + seed_offset, P, H, K)``): the two-phase loop
    estimate refits a subset of pairs with the selected rows of the same
    draws.  ``dtype`` defaults to the batch's."""
    dev = _device(device)
    p, k = batch.valid.shape
    if draws is None:
        draws = ransac_draws(config.seed + seed_offset, p, config.ransac_hypotheses, k)
    dtype = dtype or torch.as_tensor(batch.pa).dtype
    R, t, inl, za, zb = _estimate_pairs_device(
        _put(batch.pa, dev, dtype), _put(batch.pb, dev, dtype),
        _put(batch.valid, dev, torch.bool), _put(draws, dev, draws.dtype),
        config.ransac_threshold, int(config.pair_refine_iters), int(config.pair_refine_cg))
    host = torch.cat([R.reshape(p, 9), t, inl.to(R.dtype), za, zb], dim=1).cpu().numpy()
    return PairEstimates(host[:, :9].reshape(p, 3, 3), host[:, 9:12],
                         host[:, 12:12 + k] > 0.5, host[:, 12 + k:12 + 2 * k],
                         host[:, 12 + 2 * k:])


@contextlib.contextmanager
def _staged(times: Optional[dict], name: str):
    """The span ``vo.<name>`` around the enclosed stage, whose handle it
    yields; also adds the stage's wall seconds to ``times[name]`` where
    ``times`` is given.  Stages end with a host fetch of their device
    results, so a stage's time is launch + compute + readback."""
    with tracing.span(f"vo.{name}") as stage:
        if times is None:
            yield stage
            return
        t0 = time.perf_counter()
        yield stage
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0


def _chain_scales(est: PairEstimates, idx_b: np.ndarray) -> np.ndarray:
    """Propagate monocular scale between consecutive pair estimates: a point
    inlying in pairs k-1 and k is linked exactly through the shared frame
    (pair k-1's slot i is frame-k keypoint slot idx_b[k-1, i], pair k's
    slot), so the median ratio of its two depths in frame k fixes the
    relative scale.  The first pair defines scale 1."""
    p, k_cap = est.inl.shape
    scales = np.ones(p)
    for k in range(1, p):
        m_prev = est.inl[k - 1] & (idx_b[k - 1] >= 0) & (est.depths_b[k - 1] > 1e-6)
        shared = np.full(k_cap, np.nan)
        shared[idx_b[k - 1, m_prev]] = est.depths_b[k - 1, m_prev]
        m_cur = est.inl[k] & (est.depths_a[k] > 1e-6)
        d_prev = shared[np.arange(k_cap)[m_cur]]
        d_cur = est.depths_a[k, m_cur]
        ok = np.isfinite(d_prev) & (d_prev > 1e-6)
        ratio = float(np.median(d_prev[ok] / d_cur[ok])) if ok.any() else 1.0
        scales[k] = scales[k - 1] * ratio
    return scales


def _rt(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The float64 4 x 4 transform [R | t]."""
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _integrate(rels: Sequence[np.ndarray], c: Optional[np.ndarray] = None
               ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(motions, (P + 1, 4, 4) world_T_cam poses from camera 0 at the
    identity): world_T_cam_{k+1} = world_T_cam_k @ rel_k over the
    cam_k_T_cam_{k+1} ``rels``, each translation divided by c[k] first
    where ``c`` is given."""
    out, poses = [], [np.eye(4)]
    for k, rel in enumerate(rels):
        if c is not None:
            rel = rel.copy()
            rel[:3, 3] = rel[:3, 3] / c[k]
        out.append(rel)
        poses.append(poses[-1] @ rel)
    return out, np.stack(poses)


def _estimate_loops(batch: PairBatch, loop_pairs, far: np.ndarray, config: VOConfig,
                    stage_times: Optional[dict], dev: torch.device, dtype: torch.dtype
                    ) -> Tuple[PairBatch, PairEstimates]:
    """(loop batch, its estimates) of all loop pairs at the main batch's slot
    capacity (loop slots beyond it cannot link against the chain's depths),
    in two phases: RANSAC without the per-pair refinement over every
    candidate, then a refined re-estimate of only the pairs that become
    graph edges (``far`` and enough inliers), each with its own rows of the
    same draws."""
    k_cap = batch.pa.shape[1]
    lbatch = _as_pair_batch([e[2:] for e in loop_pairs], k_cap)
    ldraws = ransac_draws(config.seed + 1, lbatch.pa.shape[0], config.ransac_hypotheses, k_cap)
    cfg_fast = dataclasses.replace(config, pair_refine_iters=0)
    with _staged(stage_times, "loop_ransac"):
        lest = estimate_pairs(lbatch, cfg_fast, draws=ldraws, device=dev, dtype=dtype)
    if config.pair_refine_iters > 0:
        sel = np.nonzero(far & (lest.inl.sum(axis=1) >= 16))[0]
        if sel.size:
            sub = PairBatch(*(a[sel] for a in lbatch))
            with _staged(stage_times, "loop_refine"):
                rsub = estimate_pairs(sub, config, draws=ldraws[torch.from_numpy(sel)],
                                      device=dev, dtype=dtype)
            lest = PairEstimates(*(np.array(a) for a in lest))
            for a, b in zip(lest, rsub):
                a[sel] = b
    return lbatch, lest


def _chain_depths(est: PairEstimates, idx_b: np.ndarray, scales: np.ndarray, f: int
                  ) -> Tuple[np.ndarray, int]:
    """(chain-unit depth per frame-f keypoint slot, nan where unknown; the
    segment whose scale error it carries): from pair f when it exists, else
    pair f-1's second-frame depths remapped through its idx_b."""
    p, k_cap = est.inl.shape
    tbl = np.full(k_cap, np.nan)
    if f < p:
        m = est.inl[f] & (est.depths_a[f] > 1e-6)
        tbl[m] = est.depths_a[f, m] * scales[f]
        return tbl, f
    m = est.inl[f - 1] & (idx_b[f - 1] >= 0) & (est.depths_b[f - 1] > 1e-6)
    tbl[idx_b[f - 1, m]] = est.depths_b[f - 1, m] * scales[f - 1]
    return tbl, f - 1


def _gated_median(log_ratios: np.ndarray, mad_max: float):
    """The median of the 1-D log depth ratios, or None under 8 of them or
    where their median absolute deviation exceeds ``mad_max`` (dispersed
    ratios: the pair's geometry disagrees with the chain)."""
    if log_ratios.size < 8:
        return None
    med = np.median(log_ratios)
    return med if np.median(np.abs(log_ratios - med)) <= mad_max else None


def _revisit_rotation(pa: np.ndarray, pb: np.ndarray, inl: np.ndarray
                      ) -> Tuple[np.ndarray, float]:
    """(Kabsch rotation of the matched unit rays over the inliers ``inl``,
    their median rotation-compensated disparity, inf without inliers)."""
    qa3, qb3 = (np.concatenate([q, np.ones((q.shape[0], 1), q.dtype)], 1) for q in (pa, pb))
    qa3, qb3 = (q / np.linalg.norm(q, axis=1, keepdims=True) for q in (qa3, qb3))
    B = (qb3 * inl[:, None]).T @ qa3  # sum over inliers of qb qa^T
    U, _, Vt = np.linalg.svd(B)
    R = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    disp = np.linalg.norm(np.cross(qa3 @ R.T, qb3), axis=1)
    return R, float(np.median(disp[inl])) if inl.any() else np.inf


class _LoopEdge(NamedTuple):
    """Accepted loop pair (i, j), row ``li`` of the loop estimates: cam_j_T_cam_i
    = [R | t_unit * scale / c[i]] (``scale`` 0.0: a zero-parallax revisit);
    ``log_drift``, segment ``seg_j``'s scale drift against i's, or None."""

    i: int
    j: int
    li: int
    scale: float
    R: np.ndarray
    seg_j: Optional[int]
    log_drift: Optional[float]


def _accept_loop(i: int, j: int, li: int, linked: bool, est: PairEstimates, idx_b: np.ndarray,
                 scales: np.ndarray, lbatch: PairBatch, lest: PairEstimates, config: VOConfig
                 ) -> Optional[_LoopEdge]:
    """Loop pair ``li`` (frames i, j) as a ``_LoopEdge``, or None where it
    has too few inliers or its depth ratios against the chain disperse.
    The frame-j drift observation needs the loop's real slot linkage
    (``linked``: an idx_b was given; the batch's identity mapping would pair
    unrelated slots); slots beyond the main batch's capacity are masked."""
    p, k_cap = est.inl.shape
    if int(lest.inl[li].sum()) < 16 or i >= p:
        return None
    # Zero-parallax revisit: a coincident-camera pair breaks essential
    # RANSAC (any skew E scores every correspondence), so the revisit test
    # fits its own rotation and gates on the median R-compensated
    # disparity.  Below the gate the SE(3) measurement is [R_kabsch | 0] and
    # the drift observation is the direct chain-depth ratio.
    R_rv, d_med = _revisit_rotation(lbatch.pa[li], lbatch.pb[li], lest.inl[li] & lbatch.valid[li])
    revisit = d_med < config.revisit_disparity_max
    if revisit:
        scale, R = 0.0, R_rv
    else:
        # frame-i depths from the odometry chain, at chained scale
        m = (est.inl[i] & lest.inl[li] & (est.depths_a[i] > 1e-6) & (lest.depths_a[li] > 1e-6))
        med = _gated_median(np.log(est.depths_a[i, m] * scales[i] / lest.depths_a[li, m]),
                            config.loop_ratio_mad_max)
        if med is None:
            return None
        scale, R = float(np.exp(med)), lest.R[li]
    log_drift = seg = None
    if linked:
        tbl, seg = _chain_depths(est, idx_b, scales, j)
        lidx = lbatch.idx_b[li]
        d_j = np.where((lidx >= 0) & (lidx < k_cap), tbl[np.clip(lidx, 0, k_cap - 1)], np.nan)
        if revisit:
            lr = np.log(np.abs(est.depths_a[i] * scales[i] / d_j))
            ok = (est.inl[i] & lest.inl[li] & (est.depths_a[i] > 1e-6) & np.isfinite(lr)
                  & (d_j > 1e-6))
            med = _gated_median(lr[ok], config.loop_ratio_mad_max)
            log_drift = None if med is None else float(med)
        else:
            ok = lest.inl[li] & (lest.depths_b[li] > 1e-6) & np.isfinite(d_j)
            med = _gated_median(np.log(d_j[ok] / lest.depths_b[li, ok]),
                                config.loop_ratio_mad_max)
            log_drift = None if med is None else float(np.log(scale / float(np.exp(med))))
    return _LoopEdge(i, j, li, scale, R, None if log_drift is None else seg, log_drift)


def _scale_drift(p: int, accepted: Sequence[_LoopEdge], stage_times: Optional[dict]
                 ) -> np.ndarray:
    """(P,) scale-drift factors of the chain's segments, segment 0 the
    gauge: a linear least-squares solve of the accepted loops' relative
    drift observations, ones where no loop observes one."""
    cons = [(e.i, e.seg_j, e.log_drift) for e in accepted
            if e.seg_j is not None and e.i != e.seg_j]
    if not cons:
        return np.ones(p)
    ci, cj, cd = zip(*cons)
    with _staged(stage_times, "scale_drift"):
        log_c = posegraph.solve_scale_drift(p, np.array(ci, np.int32), np.array(cj, np.int32),
                                            np.array(cd), np.ones(len(cons)))
    return np.exp(log_c)


def _loop_edges(accepted: Sequence[_LoopEdge], far: np.ndarray, c: np.ndarray,
                lbatch: PairBatch, lest: PairEstimates, config: VOConfig,
                metrics: Optional[list]) -> list:
    """(i, j, measured T_i^-1 T_j, weight) of the accepted loops far enough
    apart (``far``), their scale with the drift ``c`` divided out; a
    ``metrics`` record for every accepted loop."""
    edges = []
    for e in accepted:
        added = bool(far[e.li])  # a short-gap loop gives only its drift observation
        if added:
            s_loop = e.scale / c[e.i] if e.scale else 0.0
            edges.append((e.i, e.j, np.linalg.inv(_rt(e.R, lest.t_unit[e.li] * s_loop)),
                          config.loop_edge_weight))
        if metrics is not None:
            rec = {"pair": (e.i, e.j), "loop_closure": True, "edge_added": added,
                   "matches": int(lbatch.valid[e.li].sum()), "inliers": int(lest.inl[e.li].sum())}
            if added:
                rec["scale"] = s_loop
            metrics.append(dict(rec, log_drift=e.log_drift))
    return edges


def _chained_graph(batch: PairBatch, est: PairEstimates, config: VOConfig,
                   loop_pairs, metrics: Optional[list], stage_times: Optional[dict],
                   dev: torch.device, dtype: torch.dtype):
    """``run_vo_matches``' host part between the pair estimates and the pose
    graph: the scale chain, the integrated odometry, the loop edges with
    their drift solve, and the pose graph.  Returns (graph, BA's loop
    links, BA's rotation edges or None, the graph's ``posegraph.optimize``
    iterations, robust delta and edge capacity).

    Loop pairs are estimated in one more batched call; each recovers its
    scale against pair i's chained depths by slot index, and with a sixth
    element idx_b also observes the relative scale drift between segments i
    and j, divided out of the chain (``_scale_drift``) before the pose
    graph runs."""
    p = batch.pa.shape[0]
    scales = _chain_scales(est, batch.idx_b)
    rels, poses = _integrate([np.linalg.inv(_rt(est.R[k], est.t_unit[k] * scales[k]))
                              for k in range(p)])  # cam_k_T_cam_{k+1}
    loop_edges = []
    ba_loop_links = []  # accepted loops' correspondences, BA's long-range track links
    n_far = 0
    if loop_pairs:
        far = np.asarray([int(e[1]) - int(e[0]) >= config.loop_edge_min_gap for e in loop_pairs])
        n_far = int(far.sum())
        lbatch, lest = _estimate_loops(batch, loop_pairs, far, config, stage_times, dev, dtype)
        accepted = []
        t_accept0 = time.perf_counter()
        for li, entry in enumerate(loop_pairs):
            linked = len(entry) > 5
            e = _accept_loop(int(entry[0]), int(entry[1]), li, linked, est, batch.idx_b, scales,
                             lbatch, lest, config)
            if e is None:
                continue
            accepted.append(e)
            if linked:
                # the real frame-j slot linkage makes the loop's inliers
                # long-range BA track links (a 5-tuple's identity would pair
                # unrelated keypoints)
                ba_loop_links.append((e.i, e.j, lbatch.pa[li], lbatch.pb[li],
                                      lest.inl[li] & lbatch.valid[li], lbatch.idx_b[li]))
        if stage_times is not None:
            stage_times["loop_accept_host"] = (stage_times.get("loop_accept_host", 0.0)
                                               + time.perf_counter() - t_accept0)
        c = _scale_drift(p, accepted, stage_times)
        rels, poses = _integrate(rels, c)
        loop_edges = _loop_edges(accepted, far, c, lbatch, lest, config, metrics)
    edges = [(k, k + 1, rel, 1.0) for k, rel in enumerate(rels)] + loop_edges
    g, rot_edges, settings = _pose_graph(poses, edges, n_far, config, dev, dtype)
    return g, ba_loop_links, rot_edges, settings


def _pose_graph(poses: np.ndarray, edges: list, n_far: int, config: VOConfig,
                dev: torch.device, dtype: torch.dtype):
    """(the pose graph on ``dev`` of ``poses`` and the (i, j, measured
    T_i^-1 T_j, weight) ``edges``, odometry first; BA's rotation edges or
    None; its ``posegraph.optimize`` (iterations, robust delta, edge
    capacity)).  Edges past the odometry's make it a loop graph; ``n_far``
    loop pairs were far enough apart to give an edge."""
    n = poses.shape[0]
    edge_i, edge_j, edge_T, edge_w = (list(x) for x in zip(*edges))
    g = posegraph.PoseGraph(
        poses=_put(poses, dev, dtype), edge_i=_put(edge_i, dev, torch.int64),
        edge_j=_put(edge_j, dev, torch.int64), edge_T=_put(np.stack(edge_T), dev, dtype),
        edge_valid=torch.ones(len(edges), dtype=torch.bool, device=dev),
        edge_weight=_put(edge_w, dev, dtype))
    if len(edges) == n - 1:
        return g, None, (config.pose_graph_iters, 0.0, None)
    # BA's rotation averaging takes the pose graph's vetted edge set
    # (odometry and far-gap loops): short-gap loops' two-view rotations
    # are too noisy (slam.py:643-655 of the JAX package).
    rot_edges = (edge_i, edge_j, [T[:3, :3] for T in edge_T], edge_w)
    # A loop pair adds at most one edge, and none below the minimum gap:
    # padded to the next power of two of that bound, sequences of one
    # length and pair count share the optimizer's CUDA graph whichever
    # loops they accept.
    capacity = 1 << (n - 2 + n_far).bit_length()
    return g, rot_edges, (config.loop_pose_graph_iters, config.loop_robust_delta, capacity)


def run_vo_matches(
    pair_data: Sequence[Tuple[np.ndarray, ...]],
    config: VOConfig,
    loop_pairs: Optional[Sequence[Tuple]] = None,
    metrics: Optional[list] = None,
    ba_refine: bool = False,
    mesh=None,
    _internals: Optional[dict] = None,
    stage_times: Optional[dict] = None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> np.ndarray:
    """Geometric VO from per-pair normalized correspondences.

    pair_data[k] = (pa, pb, valid[, idx_b]) for frames (k, k+1), in
    normalized camera coordinates.  ``loop_pairs`` optionally adds
    non-consecutive constraints (i, j, pa, pb, valid[, idx_b]), whose slots
    are frame-i keypoint slots so their scale links against pair i's
    depths.  Returns (F, 4, 4) world_T_cam poses (frame 0 at the identity)
    after pose-graph optimization, in ``dtype``.  ``metrics``, if given,
    gets one dict per pair and per accepted loop.  ``ba_refine=True`` then
    refines the trajectory with ``refine_with_ba``, its solves distributed
    over ``mesh`` (a ``parallel.mesh.Mesh``) when one is given.
    ``_internals``, if given, receives what ``refine_with_ba`` takes: the
    batch, the pair estimates, the pose graph's result, the loop links and
    the rotation edges; and the pose graph as it was assembled, before the
    optimizer pads a loop graph's edges (``graph``)."""
    if len(pair_data) == 0:
        return np.eye(4)[None]
    dev = _device(device)
    batch = _as_pair_batch(pair_data)
    with _staged(stage_times, "odom_estimate_pairs"):
        est = estimate_pairs(batch, config, device=dev, dtype=dtype)
    if metrics is not None:
        for k in range(batch.pa.shape[0]):
            metrics.append({"pair": (k, k + 1), "matches": int(batch.valid[k].sum()),
                            "inliers": int(est.inl[k].sum())})

    with tracing.span("vo.chain"):
        g, ba_loop_links, rot_edges, (iters, delta, capacity) = _chained_graph(
            batch, est, config, loop_pairs, metrics, stage_times, dev, dtype)
    with _staged(stage_times, "pose_graph") as stage:
        opt_poses, _ = posegraph.optimize(g, iters, "dense", robust_delta=delta, counts=stage,
                                          edge_capacity=capacity)
        result = opt_poses.cpu().numpy()
    if _internals is not None:
        _internals.update(batch=batch, est=est, graph_poses=result.copy(),
                          loop_links=list(ba_loop_links), rot_edges=rot_edges, graph=g)
    if ba_refine:
        result = refine_with_ba(result, batch, est, mesh=mesh, loop_links=ba_loop_links or None,
                                graph_edges=rot_edges, stage_times=stage_times, device=dev,
                                dtype=dtype)
    return result


def frontend_features(frames, config: VOConfig, *, device="cuda"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Detect and describe every frame in one batched call; returns
    device-resident (xy (F, K, 2) int32, desc (F, K, WORDS) int32, dvalid (F,
    K) bool).  Compute it once a sequence and pass it to both
    ``frontend_matches`` and ``propose_loop_closures``.  ``frames`` is a list
    of (H, W) u8 frames or an (F, H, W) u8 tensor already on the device."""
    with tracing.span("vo.frontend_features"):
        stack = frames if isinstance(frames, torch.Tensor) else np.stack(frames)
        if config.pyramid_levels > 1:
            from . import pyramid

            k_per = max(1, config.max_keypoints // config.pyramid_levels)
            feats = [pyramid.detect_and_describe_multiscale(
                im, config.threshold, config.count, k_per, n_levels=config.pyramid_levels,
                device=device) for im in stack]
            return tuple(torch.stack([getattr(f, name) for f in feats])
                         for name in ("xy0", "desc", "valid"))
        kps, desc, dvalid = brief.detect_and_describe_batch(
            stack, config.threshold, config.count, config.max_keypoints, device=device)
        return kps.xy, desc, dvalid


def _match_normalized(config: VOConfig, xy_a, desc_a, valid_a, xy_b, desc_b, valid_b):
    """Batched matching of frame pairs: (pa, pb) normalized float32, ok and
    idx_b, on the device."""
    m = match.match(desc_a, valid_a, desc_b, valid_b)
    pa, pb, ok = match.match_points(xy_a, xy_b, m)
    return (twoview.normalize_points(pa.to(torch.float32), config.camera),
            twoview.normalize_points(pb.to(torch.float32), config.camera), ok, m.idx_b)


def _to_host(na, nb, ok, idx):
    """One device -> host copy of a matched batch."""
    packed = torch.cat([na, nb, ok[..., None].to(na.dtype), idx[..., None].to(na.dtype)], -1)
    host = packed.cpu().numpy()
    return (host[..., 0:2], host[..., 2:4], host[..., 4] > 0.5,
            host[..., 5].astype(np.int32))


def frontend_matches(frames, config: VOConfig, features=None, *, device="cuda"
                     ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Per consecutive pair (pa, pb, valid, idx_b) in normalized camera
    coordinates: slot i is frame k's keypoint slot i, idx_b its matched
    keypoint slot of frame k+1.  One batched match of all pairs, one host
    copy.  ``features`` is ``frontend_features``' output, to reuse."""
    with tracing.span("vo.frontend_matches"):
        xy, desc, dvalid = features if features is not None else frontend_features(
            frames, config, device=device)
        na, nb, ok, idx = _to_host(*_match_normalized(config, xy[:-1], desc[:-1], dvalid[:-1],
                                                      xy[1:], desc[1:], dvalid[1:]))
        return [(na[k], nb[k], ok[k], idx[k]) for k in range(len(frames) - 1)]


def _frame_signatures(desc: torch.Tensor, dvalid: torch.Tensor) -> torch.Tensor:
    """Pooled per-frame descriptor signature: the mean of each BRIEF bit
    over the frame's valid keypoints, an (F, 256) float "bag of bits"."""
    f, k, w = desc.shape
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = ((desc.to(torch.int32)[..., None] >> shifts) & 1).to(torch.float32)
    bits = bits.reshape(f, k, w * 32)
    wgt = dvalid.to(torch.float32)
    s = (bits * wgt[..., None]).sum(1)
    return s / torch.clamp(wgt.sum(1), min=1.0)[..., None]


def propose_loop_closures(frames, config: VOConfig, gap: int = 5, min_matches: int = 60,
                          chunk: int = 128, top_k: Optional[int] = None, features=None, *,
                          device="cuda") -> List[Tuple]:
    """Descriptor-based loop-closure candidates: frame pairs at least ``gap``
    apart, matched in batched chunks of ``chunk`` pairs (the (C, K, K)
    distance matrices grow with K^2); pairs with at least ``min_matches``
    mutual matches become (i, j, pa, pb, valid, idx_b) constraints for
    ``run_vo_matches``, with frame-i keypoint slots.

    ``top_k`` gates the O(F^2) enumeration by frame signatures: frame i
    matches only its ``top_k`` most signature-similar partners j >= i + gap.
    None is exhaustive up to 64 frames and 8 beyond; 0 forces exhaustive.
    The call is the span ``vo.loop_propose``."""
    with tracing.span("vo.loop_propose"):
        f = len(frames)
        if top_k is None:
            top_k = 0 if f <= 64 else 8
        xy, desc, dvalid = features if features is not None else frontend_features(
            frames, config, device=device)
        if top_k:
            sig = _frame_signatures(desc, dvalid).cpu().numpy()
            sig = sig - sig.mean(axis=0)  # centre: shared-background bits
            nrm = np.linalg.norm(sig, axis=1)
            sim = (sig @ sig.T) / np.maximum(np.outer(nrm, nrm), 1e-9)
            cand = []
            for i in range(f):
                js = np.arange(i + gap, f)
                if js.size == 0:
                    continue
                order = js[np.argsort(-sim[i, js])][: int(top_k)]
                cand.extend((i, int(j)) for j in np.sort(order))
        else:
            cand = [(i, j) for i in range(f) for j in range(i + gap, f)]
        if not cand:
            return []
        ii = torch.as_tensor([c[0] for c in cand], device=xy.device)
        jj = torch.as_tensor([c[1] for c in cand], device=xy.device)
        parts = []
        for s in range(0, len(cand), chunk):
            a, b = ii[s:s + chunk], jj[s:s + chunk]
            parts.append(_match_normalized(config, xy[a], desc[a], dvalid[a], xy[b], desc[b],
                                           dvalid[b]))
        na, nb, ok, idx = _to_host(*(torch.cat(x) for x in zip(*parts)))
        counts = ok.sum(axis=1)
        return [(cand[c][0], cand[c][1], na[c], nb[c], ok[c], idx[c])
                for c in range(len(cand)) if counts[c] >= min_matches]


def run_vo_images(frames, config: VOConfig, *, loop_closure_gap: Optional[int] = None,
                  metrics: Optional[list] = None, ba_refine: bool = False, mesh=None,
                  device="cuda", dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Images -> trajectory (F, 4, 4).  With ``loop_closure_gap``, distant
    frame pairs are matched and added as pose-graph constraints;
    ``ba_refine`` and ``mesh`` are ``run_vo_matches``'.  Frames are detected
    and described once; the features feed both consecutive-pair matching
    and loop proposal."""
    feats = frontend_features(frames, config, device=device)
    loops = (propose_loop_closures(frames, config, gap=loop_closure_gap, features=feats)
             if loop_closure_gap else None)
    return run_vo_matches(frontend_matches(frames, config, features=feats), config,
                          loop_pairs=loops, metrics=metrics, ba_refine=ba_refine, mesh=mesh,
                          device=device, dtype=dtype)


def build_tracks(batch: PairBatch, est: PairEstimates, min_len: int = 3,
                 loop_links: Optional[Sequence[Tuple]] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Link pair-wise inlier correspondences into multi-frame tracks.

    Linking is exact: pair k's inlier slot i observes frame k at keypoint
    slot i and frame k+1 at keypoint slot idx_b[k, i].  ``loop_links``,
    (i, j, pa, pb, inl, idx_b) per accepted loop pair, add the long-range
    links: loop slot s joins frame-i slot s to frame-j slot idx_b[s].  A loop
    link can merge two tracks of distant chain segments, so identity is
    resolved by union-find over the (frame, slot) nodes.  A component that
    observes one frame at two different slots marks a wrong link and is
    dropped whole.

    Returns flat observation arrays (obs_cam, obs_lm, obs_uv), sorted by
    (track, frame), for tracks observed in >= ``min_len`` frames."""
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, 2)))
    parent: List[int] = []
    uv_list: List[np.ndarray] = []
    frame_list: List[int] = []
    node_id: dict = {}

    def get_node(f: int, s: int, uv) -> int:
        nid = node_id.get((f, s))
        if nid is None:
            nid = len(parent)
            node_id[(f, s)] = nid
            parent.append(nid)
            uv_list.append(uv)
            frame_list.append(f)
        return nid

    def find(a: int) -> int:
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:  # path compression
            parent[a], a = root, parent[a]
        return root

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for k in range(est.inl.shape[0]):
        m = est.inl[k] & (batch.idx_b[k] >= 0)
        for s in np.nonzero(m)[0]:
            union(get_node(k, int(s), batch.pa[k, s]),
                  get_node(k + 1, int(batch.idx_b[k, s]), batch.pb[k, s]))
    for (i, j, lpa, lpb, linl, lidx) in (loop_links or ()):
        m = np.asarray(linl, bool) & (np.asarray(lidx) >= 0)
        for s in np.nonzero(m)[0]:
            union(get_node(int(i), int(s), lpa[s]), get_node(int(j), int(lidx[s]), lpb[s]))

    n_nodes = len(parent)
    if n_nodes == 0:
        return empty
    roots = np.fromiter((find(x) for x in range(n_nodes)), np.int64, n_nodes)
    frames = np.asarray(frame_list, np.int64)
    _, tid = np.unique(roots, return_inverse=True)
    n_tracks = int(tid.max()) + 1

    order = np.lexsort((frames, tid))
    t_sorted = tid[order]
    f_sorted = frames[order]
    # the same track and frame in adjacent sorted rows: a double observation
    # of one frame, so the whole track is inconsistent
    dup = np.zeros(n_nodes, bool)
    dup[1:] = (t_sorted[1:] == t_sorted[:-1]) & (f_sorted[1:] == f_sorted[:-1])
    track_bad = np.zeros(n_tracks, bool)
    np.logical_or.at(track_bad, t_sorted[dup], True)

    counts = np.bincount(tid, minlength=n_tracks)
    keep = (~track_bad) & (counts >= min_len)
    remap = -np.ones(n_tracks, np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    sel = keep[t_sorted]
    uv_arr = np.asarray(uv_list, np.float64).reshape(-1, 2)[order]
    return f_sorted[sel].astype(np.int32), remap[t_sorted[sel]].astype(np.int32), uv_arr[sel]


def triangulate_tracks(w2c: np.ndarray, obs_cam: np.ndarray, obs_lm: np.ndarray,
                       obs_uv: np.ndarray, n_lm: int) -> np.ndarray:
    """Multi-view DLT triangulation of every track at once, on the host.

    Each observation contributes the rows u (P X)_z - (P X)_x and
    v (P X)_z - (P X)_y (P = w2c[:3, :], normalized coordinates); per track
    the 4 x 4 normal matrix accumulates by segment sum and X is its
    smallest-eigenvalue eigenvector (float64 ``eigh``).  All observations
    count: a loop track's first and last frames sit at a revisit (tiny
    baseline), its middle frames span the real one."""
    Pm = w2c[obs_cam][:, :3, :]  # (O, 3, 4)
    r1 = obs_uv[:, 0, None] * Pm[:, 2] - Pm[:, 0]
    r2 = obs_uv[:, 1, None] * Pm[:, 2] - Pm[:, 1]
    rows = np.stack([r1, r2], axis=1)  # (O, 2, 4)
    M = np.zeros((n_lm, 4, 4))
    np.add.at(M, obs_lm, np.einsum("ori,orj->oij", rows, rows))
    _, V = np.linalg.eigh(M)
    X = V[..., 0]  # ascending eigenvalues: column 0 is the smallest
    w = X[:, 3]
    w = np.where(np.abs(w) < 1e-9, np.where(w < 0, -1e-9, 1e-9), w)
    return X[:, :3] / w[:, None]


def refine_with_ba(poses: np.ndarray, batch: PairBatch, est: PairEstimates,
                   iterations: int = 8, cg_iters: int = 30, mesh=None,
                   windowed_threshold: int = 16, window: int = 8, stride: int = 5,
                   loop_links=None, graph_edges=None, robust_delta: float = 0.01,
                   loop_ba_rounds: int = 2, loop_ba_iters: int = 20, loop_cg_iters: int = 40,
                   stage_times: Optional[dict] = None, *, device="cuda",
                   dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Structure-from-motion refinement of a VO trajectory: build tracks
    (loop links included), triangulate them from the current poses, run
    Schur-complement BA (camera 0 fixed), return refined world_T_cam poses.

    Routes, as the JAX package's (slam.py:1031-1166):

    * with loop links: rotation averaging over ``graph_edges``
      (``posegraph.rotation_average``, float32 as in the JAX package)
      replaces the absolute rotations, then ``loop_ba_rounds`` rounds of
      {multi-view re-triangulation -> per-observation gating -> global
      Huber-IRLS BA};
    * without loops, at least ``windowed_threshold`` frames: sliding-window
      BA (``windowed_ba``), the windows one batched problem, split over the
      mesh's data devices when a mesh is given;
    * short loop-free trajectories: one global plain BA.

    With ``mesh`` the global solves run distributed (observations split,
    Schur reductions summed across the shards, ``parallel.ba_sharded``).
    The solves run on ``device`` in ``dtype``; each ends with one host
    fetch.  ``stage_times`` keys: ``tracks_host``, ``rotation_avg``,
    ``triangulate_gate_host``, ``ba_solve``.  While a profiler records, each
    ``vo.ba_solve`` span of a one-device global solve counts ``ba.optimize``'s
    ``solves``, ``lm_steps`` and ``cg_steps``, and ``lm_accepted``, the steps
    that lowered the cost, read in the same fetch as the result."""
    dev = _device(device)
    with _staged(stage_times, "tracks_host"):
        obs_cam, obs_lm, obs_uv = build_tracks(batch, est, loop_links=loop_links)
    if obs_lm.size == 0:
        return poses
    n_lm = int(obs_lm.max()) + 1

    def gated_problem(cur_poses: np.ndarray):
        """(w2c, points, per-observation validity) under the current
        trajectory.  Culling is per observation (a track survives while >= 2
        of its observations do): a long loop track's far end reprojects
        worst before refinement, and BA needs exactly those observations."""
        w2c = np.linalg.inv(cur_poses)
        pts = triangulate_tracks(w2c, obs_cam, obs_lm, obs_uv, n_lm)
        Xc = np.einsum("oij,oj->oi", w2c[obs_cam][:, :3, :3], pts[obs_lm]) + w2c[obs_cam][:, :3, 3]
        depth_ok = Xc[:, 2] > 1e-3
        proj = Xc[:, :2] / np.maximum(Xc[:, 2:3], 1e-9)
        obs_ok = depth_ok & (np.linalg.norm(proj - obs_uv, axis=1) < 0.02)
        n_valid = np.bincount(obs_lm[obs_ok], minlength=n_lm)
        return w2c, pts, obs_ok & (n_valid >= 2)[obs_lm]

    def solve(w2c, pts, valid, iters, cg, delta, counts=None):
        # Only camera 0 is fixed: pinning a second (noisy) camera would
        # anchor BA to its error; the scale gauge is a damped null direction.
        problem = ba_lib.BAProblem(
            _put(w2c, dev, dtype), _put(pts, dev, dtype), _put(obs_cam, dev, torch.int64),
            _put(obs_lm, dev, torch.int64), _put(obs_uv, dev, dtype),
            _put(valid, dev, torch.bool), n_fixed_cams=1)
        if mesh is not None:
            from ..parallel import ba_sharded

            new_w2c, _, _ = ba_sharded.optimize_sharded(problem, iters, cg, 1e-4, delta, mesh=mesh)
            return np.linalg.inv(new_w2c.cpu().numpy())
        new_w2c, _, costs = ba_lib.optimize(problem, iters, cg, 1e-4, delta, counts=counts)
        if not counts:
            return np.linalg.inv(new_w2c.cpu().numpy())
        # While a profiler records, the steps that lowered the cost come back
        # in the result's one fetch.
        flags = ba_lib.lowered(costs, ba_lib.total_cost(problem, delta))
        host = torch.cat([new_w2c.reshape(-1), flags.to(new_w2c.dtype)]).cpu().numpy()
        counts.add("lm_accepted", int(host[new_w2c.numel():].sum()))
        return np.linalg.inv(host[:new_w2c.numel()].reshape(new_w2c.shape))

    if loop_links is not None and len(loop_links) > 0:
        cur = np.array(poses)
        if graph_edges is not None:
            with _staged(stage_times, "rotation_avg"):
                ei, ej, eR, ew = graph_edges
                eR = np.asarray([np.asarray(R)[:3, :3] for R in eR])
                Rw = posegraph.rotation_average(
                    _put(cur[:, :3, :3], dev, torch.float32), _put(ei, dev, torch.int64),
                    _put(ej, dev, torch.int64), _put(eR, dev, torch.float32),
                    _put(ew, dev, torch.float32))
                cur[:, :3, :3] = Rw.cpu().numpy()
        for _ in range(int(loop_ba_rounds)):
            with _staged(stage_times, "triangulate_gate_host"):
                w2c, pts, valid = gated_problem(cur)
            with _staged(stage_times, "ba_solve") as stage:
                cur = solve(w2c, pts, valid, int(loop_ba_iters), int(loop_cg_iters),
                            float(robust_delta), counts=stage)
        return cur

    with _staged(stage_times, "triangulate_gate_host"):
        w2c, pts, valid = gated_problem(poses)
    if poses.shape[0] >= int(windowed_threshold):
        from . import windowed_ba

        sel = np.nonzero(valid)[0]
        with _staged(stage_times, "ba_solve"):
            new_w2c = windowed_ba.refine_trajectory_windowed(
                w2c, pts, obs_cam[sel], obs_lm[sel], obs_uv[sel], window=int(window),
                stride=int(stride), iterations=int(iterations), mesh=mesh, device=dev,
                dtype=dtype)
        return np.linalg.inv(new_w2c)

    with _staged(stage_times, "ba_solve") as stage:
        return solve(w2c, pts, valid, int(iterations), int(cg_iters), 0.0, counts=stage)


def evaluate_ate(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Scale-aligned ATE RMSE between world_T_cam trajectories."""
    return ate_rmse(est_poses[:, :3, 3], gt_poses[:, :3, 3], align=True, with_scale=True)
