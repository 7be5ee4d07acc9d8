"""The port's visual-odometry slice against the JAX package.

* ``run_vo_matches`` on seeded synthetic correspondences (6 frames, the
  JAX tests' cloud-and-trajectory construction), float64 on both sides
  (the ``x64`` fixture), with the JAX package's RANSAC draws injected into
  the port (``slam.ransac_draws`` replaced by one that returns
  ``jax.random.uniform`` of the keys ``jax.random.split(PRNGKey(seed), P)``
  the JAX package draws from): poses agree to 1e-6, without and with a loop
  pair; ATE < 1e-3 on exact correspondences.
* ``run_vo_images`` on 4 frames rendered at 320 x 240 with K=128, float32
  on both sides as the JAX package runs it by default: the front-end is
  bit-exact, so the correspondences are equal; the trajectories agree to
  the tolerance stated in the test.
* ``io.render`` frames are byte-identical to the JAX package's.
* Bundle adjustment, float64: ``build_tracks`` equal to the JAX package's
  on random batches with loop links (conflicting links included),
  ``triangulate_tracks`` to 1e-12, ``refine_with_ba`` on its three routes
  (loops, global, windowed) at reduced budgets to the tolerances stated in
  the test, and ``run_vo_matches(ba_refine=True)`` at the default budgets,
  with and without a loop pair and on an 8-device CPU mesh, to a pose and
  ATE tolerance (the default CG budgets run past the rounding floor).
* Structure: the TF32 guard restores its flag, configurations carry across
  (``vo_config_from``), the default device is CUDA.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.io import render as jrender
from feature_detector_fast_tpu.models import slam as jslam
from feature_detector_fast_tpu_torch.io import render
from feature_detector_fast_tpu_torch.models import lie, slam
from feature_detector_fast_tpu_torch.utils import metrics, precision

#: Hypotheses of the synthetic runs (both sides): fewer than the default
#: 256 keeps the CPU run short; the draws are the JAX package's either way.
HYP = 64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_draws(seed: int, pairs: int, hypotheses: int, slots: int) -> torch.Tensor:
    """The draws the JAX package's estimate_pairs ranks with (slam.py:239,
    twoview.py:244), in the JAX dtype of the moment."""
    keys = jax.random.split(jax.random.PRNGKey(seed), pairs)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (hypotheses, slots)))
                                      for k in keys]))


@pytest.fixture()
def inject_jax_draws(monkeypatch):
    monkeypatch.setattr(slam, "ransac_draws", jax_draws)


def se3(xi) -> np.ndarray:
    return lie.se3_exp(torch.tensor(np.asarray(xi, np.float64))).numpy()


def make_trajectory(n_frames, step=0.4, turn=0.06) -> np.ndarray:
    poses = [np.eye(4)]
    for k in range(n_frames - 1):
        poses.append(poses[-1] @ se3([0.03 * np.sin(k), 0.0, step, 0.0, turn, 0.0]))
    return np.stack(poses)


def project(lm, T, noise=0.0, rng=None):
    """Normalized projection and visibility of landmarks ``lm`` from
    world_T_cam ``T``; slot i is landmark i."""
    Xc = (np.linalg.inv(T) @ np.concatenate([lm, np.ones((len(lm), 1))], 1).T).T[:, :3]
    vis = Xc[:, 2] > 0.5
    p = Xc[:, :2] / np.maximum(Xc[:, 2:3], 1e-9)
    vis &= (np.abs(p[:, 0]) < 0.7) & (np.abs(p[:, 1]) < 0.55)
    if noise:
        p = p + rng.normal(0, noise, p.shape)
    return p, vis


def synth(rng, gt, n_pts=400, noise=0.0):
    """(pair_data, landmarks) of one shared cloud, tests/test_slam.py's
    construction."""
    lm = np.stack([rng.uniform(-6, 10, n_pts), rng.uniform(-4, 4, n_pts),
                   rng.uniform(-2, 22, n_pts)], -1)
    projs = [project(lm, T, noise, rng) for T in gt]
    return [(projs[k][0], projs[k + 1][0], projs[k][1] & projs[k + 1][1])
            for k in range(len(gt) - 1)], lm


@pytest.mark.parametrize("loops,noise", [(False, 0.0), (True, 0.0), (True, 2e-4)])
def test_run_vo_matches_matches_jax(x64, rng, inject_jax_draws, loops, noise):
    """Odometry and odometry + a loop pair (a clean 6-tuple loop (0, 5) with
    identity idx_b), on exact or noisy correspondences: equal poses to
    1e-6, the same accepted loop and its drift observation; ATE < 1e-3 on
    exact correspondences, < 2% of the trajectory on noisy ones."""
    gt = make_trajectory(6)
    pair_data, lm = synth(rng, gt, noise=noise)
    loop_pairs = None
    if loops:
        p0, v0 = project(lm, gt[0])
        p5, v5 = project(lm, gt[5])
        loop_pairs = [(0, 5, p0, p5, v0 & v5, np.arange(len(lm), dtype=np.int32))]
    jcfg = jslam.VOConfig(ransac_hypotheses=HYP)
    cfg = slam.vo_config_from(jcfg)
    jmets, mets, st = [], [], {}
    want = jslam.run_vo_matches(list(pair_data), jcfg, loop_pairs=loop_pairs, metrics=jmets)
    got = slam.run_vo_matches(list(pair_data), cfg, loop_pairs=loop_pairs, metrics=mets,
                              stage_times=st, device="cpu", dtype=torch.float64)
    assert got.dtype == np.float64 and got.shape == (6, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert [m["pair"] for m in mets] == [m["pair"] for m in jmets]
    for m, jm in zip(mets, jmets):
        assert abs(m["inliers"] - jm["inliers"]) <= 1, (m, jm)
        if m.get("log_drift") is not None:
            assert abs(m["log_drift"] - jm["log_drift"]) < 1e-6
    ate = slam.evaluate_ate(got, gt)
    if loops:
        assert any(m.get("edge_added") for m in mets), mets
        assert {"odom_estimate_pairs", "loop_ransac", "loop_refine", "pose_graph"} <= set(st)
    if noise:
        assert ate < 0.02 * np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum()
    else:
        assert ate < 1e-3, ate


def test_run_vo_images_matches_jax(monkeypatch):
    """4 rendered frames, K=128, float32: equal matches and equal inlier
    counts, poses within 0.02 of the JAX package's (measured 0.0058 on a
    1.06-long trajectory).  The gap is the refit's eigen-solve of the
    float32 normal matrix A^T A (twoview.py:283-284): the JAX package solves
    it in float32, the port in float64 (cuSOLVER's float32 solver misses the
    smallest eigenvector); the per-pair Gauss-Newton carries the difference
    on.  ATE within 4% of the trajectory, the JAX package's float32 gate
    (tests/test_render_vo.py:47)."""
    monkeypatch.setattr(slam, "ransac_draws", jax_draws)
    cfg = render.RenderConfig()
    gt = render.demo_trajectory(4)
    frames = render.render_sequence(gt, cfg)
    jcfg = jslam.VOConfig(max_keypoints=128, camera=jrender.RenderConfig().camera(),
                          ransac_hypotheses=HYP)
    vcfg = slam.vo_config_from(jcfg)
    assert vcfg.camera == cfg.camera()
    feats = slam.frontend_features(frames, vcfg, device="cpu")
    pd = slam.frontend_matches(frames, vcfg, features=feats, device="cpu")
    jpd = jslam.frontend_matches(frames, jcfg)
    for (na, nb, ok, idx), jm in zip(pd, jpd):
        np.testing.assert_array_equal(ok, np.asarray(jm[2]))
        np.testing.assert_array_equal(idx, np.asarray(jm[3]))
        # the same pixels; XLA's float32 (x - cx) / fx may round an ulp apart
        np.testing.assert_allclose(na, np.asarray(jm[0]), rtol=0, atol=6e-8)
        np.testing.assert_allclose(nb, np.asarray(jm[1]), rtol=0, atol=6e-8)
    mets, jmets = [], []
    got = slam.run_vo_images(frames, vcfg, metrics=mets, device="cpu")
    want = jslam.run_vo_images(frames, jcfg, metrics=jmets)
    assert mets == jmets
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02)
    traj = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum()
    assert slam.evaluate_ate(got, gt) < 0.04 * traj


def test_render_byte_identical():
    """Frames of the port's renderer equal the JAX package's, clean and with
    every degradation and interior boxes."""
    gt = jrender.loop_trajectory(3, radius=2.0)
    np.testing.assert_array_equal(gt, render.loop_trajectory(3, radius=2.0))
    np.testing.assert_array_equal(jrender.demo_trajectory(5), render.demo_trajectory(5))
    for kw in ({}, dict(width=160, height=120, n_boxes=6, noise_sigma=4.0, blur=True,
                        vignette=0.25, seed=3, z_back=12.0, cell=0.3)):
        want = jrender.render_sequence(gt, jrender.RenderConfig(**kw))
        got = render.render_sequence(gt, render.RenderConfig(**kw))
        for a, b in zip(got, want):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


def test_metrics_match_reference(rng):
    from feature_detector_fast_tpu.utils import metrics as jmetrics

    gt = make_trajectory(8)
    est = gt.copy()
    est[:, :3, 3] = 2.0 * est[:, :3, 3] + rng.normal(0, 0.01, (8, 3))
    for f in ("ate_rmse", "umeyama_alignment"):
        for with_scale in (False, True):
            got = getattr(metrics, f)(est[:, :3, 3], gt[:, :3, 3], with_scale=with_scale)
            want = getattr(jmetrics, f)(est[:, :3, 3], gt[:, :3, 3], with_scale=with_scale)
            for a, b in zip(np.atleast_1d(np.asarray(got, dtype=object)),
                            np.atleast_1d(np.asarray(want, dtype=object))):
                np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64))
    assert metrics.rpe_rmse(est, gt) == jmetrics.rpe_rmse(est, gt)
    assert slam.evaluate_ate(est, gt) == jslam.evaluate_ate(est, gt)


def test_ba_refine_raises_and_empty_input():
    """``ba_refine=True`` runs (it raised before global BA was ported): on
    degenerate input (no inliers, so no tracks) it returns the pose graph's
    trajectory; an empty sequence is frame 0 at the identity."""
    pd = [(np.zeros((8, 2)),) * 2 + (np.ones(8, bool),)]
    want = slam.run_vo_matches(pd, slam.VOConfig(), device="cpu")
    got = slam.run_vo_matches(pd, slam.VOConfig(), ba_refine=True, device="cpu")
    np.testing.assert_array_equal(got, want)
    from feature_detector_fast_tpu_torch.parallel import mesh as meshlib

    frames = [np.zeros((64, 64), np.uint8)] * 2
    mesh = meshlib.make_mesh(devices=[torch.device("cpu")] * 8)
    assert slam.run_vo_images(frames, slam.VOConfig(), ba_refine=True, mesh=mesh,
                              device="cpu").shape == (2, 4, 4)
    np.testing.assert_array_equal(slam.run_vo_matches([], slam.VOConfig(), device="cpu"),
                                  np.eye(4)[None])


def random_tracks_batch(rng, p=6, k=40):
    """A PairBatch / PairEstimates of random slot links (each pair's idx_b a
    permutation with gaps), random inliers, and loop links between random
    frames, some of them conflicting."""
    pa = rng.normal(0, 0.3, (p, k, 2))
    pb = rng.normal(0, 0.3, (p, k, 2))
    valid = rng.random((p, k)) < 0.9
    idx_b = np.stack([rng.permutation(k) for _ in range(p)]).astype(np.int32)
    idx_b = np.where(valid, idx_b, -1)
    inl = valid & (rng.random((p, k)) < 0.8)
    batch = slam.PairBatch(pa, pb, valid, idx_b)
    est = slam.PairEstimates(np.tile(np.eye(3), (p, 1, 1)), np.zeros((p, 3)), inl,
                             np.ones((p, k)), np.ones((p, k)))
    links = []
    for _ in range(4):
        i = int(rng.integers(0, p - 2))
        j = int(rng.integers(i + 2, p + 1))
        lidx = np.where(rng.random(k) < 0.7, rng.permutation(k), -1).astype(np.int32)
        links.append((i, j, rng.normal(0, 0.3, (k, 2)), rng.normal(0, 0.3, (k, 2)),
                      rng.random(k) < 0.5, lidx))
    return batch, est, links


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_tracks_matches_jax(seed):
    """Union-find tracks equal the JAX package's, without and with loop
    links, at min_len 2 and 3; random links make conflicting components
    (one frame seen at two slots), which both drop whole."""
    batch, est, links = random_tracks_batch(np.random.default_rng(seed))
    for loop_links in (None, links):
        for min_len in (2, 3):
            got = slam.build_tracks(batch, est, min_len, loop_links)
            want = jslam.build_tracks(batch, est, min_len, loop_links)
            assert got[0].dtype == np.int32 and got[1].dtype == np.int32
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    assert len(slam.build_tracks(batch, est, 2, links)[0]) > 0


def test_build_tracks_merges_loop_links():
    """tests/test_slam.py's case on the port: a loop link merges two chain
    tracks into one long-range track; a conflicting link drops its track
    whole.  Equal to the JAX package's output at each step."""
    P, K = 4, 6
    pa = np.zeros((P, K, 2))
    pb = np.zeros((P, K, 2))
    for k in range(P):
        for s in range(K):
            pa[k, s] = [k + 0.01 * s, s]
            pb[k, s] = [k + 1 + 0.01 * s, s]
    batch = slam.PairBatch(pa, pb, np.ones((P, K), bool),
                           np.tile(np.arange(K, dtype=np.int32), (P, 1)))
    inl = np.zeros((P, K), bool)
    inl[0, 0] = inl[3, 1] = True
    est = slam.PairEstimates(np.tile(np.eye(3), (P, 1, 1)), np.zeros((P, 3)), inl,
                             np.ones((P, K)), np.ones((P, K)))
    lpa, lpb = np.zeros((K, 2)), np.zeros((K, 2))
    lpa[0], lpb[0] = pa[0, 0], pb[3, 1]
    linl = np.zeros(K, bool)
    linl[0] = True
    lidx = np.full(K, -1, np.int32)
    lidx[0] = 1
    cases = [((2, None), 2, None), ((3, [(0, 4, lpa, lpb, linl, lidx)]), 1, [0, 1, 3, 4]),
             ((2, [(0, 1, lpa, lpb, linl, lidx)]), 1, [3, 4])]
    for (min_len, links), n_tracks, frames in cases:
        got = slam.build_tracks(batch, est, min_len, links)
        for a, b in zip(got, jslam.build_tracks(batch, est, min_len, links)):
            np.testing.assert_array_equal(a, b)
        assert int(got[1].max()) + 1 == n_tracks
        if frames is not None:
            assert got[0].tolist() == frames


def ba_inputs(rng, n_frames=8, n_pts=300, noise=8e-4):
    """Host inputs of refine_with_ba from a seeded synthetic scene: the
    ground truth, perturbed world_T_cam poses, a PairBatch of consecutive
    pairs (slot == landmark id), estimates whose inliers drop 10% of the
    valid slots, a loop link between the first and last frames and the
    relative-rotation edges of the chain plus that loop."""
    gt = make_trajectory(n_frames)
    pair_data, lm = synth(rng, gt, n_pts, noise)
    batch = slam._as_pair_batch(pair_data)
    p, k = batch.valid.shape
    est = slam.PairEstimates(np.tile(np.eye(3), (p, 1, 1)), np.zeros((p, 3)),
                             batch.valid & (rng.random((p, k)) > 0.1), np.ones((p, k)),
                             np.ones((p, k)))
    poses = gt.copy()
    for i in range(1, n_frames):
        poses[i] = poses[i] @ se3(rng.normal(0, 0.01, 6))
    p0, v0 = project(lm, gt[0], noise, rng)
    p1, v1 = project(lm, gt[-1], noise, rng)
    ident = np.arange(n_pts, dtype=np.int32)
    links = [(0, n_frames - 1, p0, p1, v0 & v1, np.where(v0 & v1, ident, -1))]
    ei = list(range(n_frames - 1)) + [0]
    ej = list(range(1, n_frames)) + [n_frames - 1]
    eR = [(np.linalg.inv(gt[i]) @ gt[j])[:3, :3] @ se3([0, 0, 0, *rng.normal(0, 0.003, 3)])[:3, :3]
          for i, j in zip(ei, ej)]
    return gt, poses, batch, est, links, (ei, ej, eR, [1.0] * len(ei))


@pytest.mark.parametrize("route", ["loops", "global", "windowed"])
def test_refine_with_ba_matches_jax(x64, route):
    """refine_with_ba on each route against the JAX package's, float64:
    loops at 2 rounds x 2 iterations x 12 CG steps to 1e-5 (the rotation
    averaging runs in float32 on both sides, as the JAX package runs it);
    global at 2 x 12 to 1e-9.  The windowed route's CG budget is fixed at
    20 steps (refine_windows' default, as in the JAX package), past the
    rounding floor of these 6-camera windows (a step agrees to 1e-14 at 10
    CG steps, 2e-3 at 20), so it is held to 1e-3 and its ATE to 5%;
    tests/test_torch_windowed_ba.py holds refine_windows tightly at 8 steps.
    Each route must also lower ATE."""
    gt, poses, batch, est, links, edges = ba_inputs(np.random.default_rng(7))
    kw, tol = {
        "loops": (dict(loop_links=links, graph_edges=edges, loop_ba_iters=2, loop_cg_iters=12),
                  1e-5),
        "global": (dict(iterations=2, cg_iters=12), 1e-9),
        "windowed": (dict(iterations=2, windowed_threshold=8, window=6, stride=2), 1e-3)}[route]
    st = {}
    got = slam.refine_with_ba(poses, batch, est, stage_times=st, device="cpu",
                              dtype=torch.float64, **kw)
    want = jslam.refine_with_ba(poses, batch, est, **kw)
    assert got.dtype == np.float64 and got.shape == poses.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert {"tracks_host", "triangulate_gate_host", "ba_solve"} <= set(st)
    assert ("rotation_avg" in st) == (route == "loops")
    ate = slam.evaluate_ate(got, gt)
    assert abs(ate - slam.evaluate_ate(want, gt)) < 0.05 * ate
    assert ate < slam.evaluate_ate(poses, gt)


def test_triangulate_tracks_matches_jax(x64):
    """Multi-view DLT of every track: equal to the JAX package's to 1e-12."""
    gt, poses, batch, est, links, _ = ba_inputs(np.random.default_rng(3), n_pts=120)
    oc, ol, uv = slam.build_tracks(batch, est, loop_links=links)
    w2c = np.linalg.inv(poses)
    n_lm = int(ol.max()) + 1
    got = slam.triangulate_tracks(w2c, oc, ol, uv, n_lm)
    np.testing.assert_allclose(got, jslam.triangulate_tracks(w2c, oc, ol, uv, n_lm), rtol=0,
                               atol=1e-12)
    assert got.shape == (n_lm, 3) and np.isfinite(got).all()


@pytest.mark.parametrize("loops", [False, True])
def test_run_vo_matches_ba_refine_matches_jax(x64, rng, inject_jax_draws, loops):
    """run_vo_matches(ba_refine=True) at the default budgets (8 x 30 without
    loops; rotation averaging and 2 x 20 x 40 with a loop pair) against the
    JAX package's, float64, the JAX package's draws: poses within 1e-4 (the
    CG budgets run past the rounding floor, where two correct runs part),
    ATE within 2% of the JAX package's and below the pose graph's.  The same
    run on an 8-device CPU mesh (sharded solves) gives ATE within 0.25
    relative, tests/test_slam.py:197's margin."""
    from feature_detector_fast_tpu_torch.parallel import mesh as meshlib

    gt = make_trajectory(6)
    pair_data, lm = synth(rng, gt, noise=8e-4)
    loop_pairs = None
    if loops:
        p0, v0 = project(lm, gt[0])
        p5, v5 = project(lm, gt[5])
        loop_pairs = [(0, 5, p0, p5, v0 & v5, np.arange(len(lm), dtype=np.int32))]
    jcfg = jslam.VOConfig(ransac_hypotheses=HYP)
    cfg = slam.vo_config_from(jcfg)
    want = jslam.run_vo_matches(list(pair_data), jcfg, loop_pairs=loop_pairs, ba_refine=True)
    internals, st = {}, {}
    got = slam.run_vo_matches(list(pair_data), cfg, loop_pairs=loop_pairs, ba_refine=True,
                              _internals=internals, stage_times=st, device="cpu",
                              dtype=torch.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    ate, ate_jax = slam.evaluate_ate(got, gt), slam.evaluate_ate(want, gt)
    assert abs(ate - ate_jax) < 0.02 * ate_jax, (ate, ate_jax)
    assert ate < slam.evaluate_ate(internals["graph_poses"], gt)
    assert ("rotation_avg" in st) == loops and len(internals["loop_links"]) == int(loops)
    assert (internals["rot_edges"] is not None) == loops
    mesh = meshlib.make_mesh(devices=[torch.device("cpu")] * 8)
    sharded = slam.run_vo_matches(list(pair_data), cfg, loop_pairs=loop_pairs, ba_refine=True,
                                  mesh=mesh, device="cpu", dtype=torch.float64)
    a8 = slam.evaluate_ate(sharded, gt)
    assert abs(a8 - ate) < 0.25 * max(a8, ate), (ate, a8)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device works here")
    pd = [(np.zeros((8, 2)), np.zeros((8, 2)), np.ones(8, bool))]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slam.run_vo_matches(pd, slam.VOConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slam.estimate_pairs(slam._as_pair_batch(pd), slam.VOConfig())


def test_tf32_guard_restores_the_flag():
    matmul = torch.backends.cuda.matmul
    new_api = hasattr(matmul, "fp32_precision")  # PyTorch 2.9 and later
    old = torch.get_float32_matmul_precision(), new_api and matmul.fp32_precision

    def read_back():
        """The caller's setting, through the API it was made in."""
        if isinstance(start, bool):
            return matmul.allow_tf32
        return matmul.fp32_precision if start == "tf32" else torch.get_float32_matmul_precision()

    starts = ["medium", "high", "highest", True, False] + (["tf32"] if new_api else [])
    try:
        for start in starts:
            if isinstance(start, bool):
                matmul.allow_tf32 = start
            elif start == "tf32":
                matmul.fp32_precision = start
            else:
                torch.set_float32_matmul_precision(start)
            seen = []

            @precision.matmul_highest
            def f():
                seen.append(matmul.allow_tf32)
                raise ValueError("inside")

            with pytest.raises(ValueError):
                f()
            with precision.tf32_off():
                seen.append(matmul.allow_tf32)
            assert seen == [False, False], start
            assert read_back() == start, start
    finally:
        torch.set_float32_matmul_precision(old[0])
        if new_api:
            matmul.fp32_precision = old[1]


def test_vo_config_from():
    jcfg = jslam.VOConfig(max_keypoints=300, loop_edge_min_gap=48, loop_ratio_mad_max=0.15,
                          camera=jrender.RenderConfig(width=640, height=480).camera())
    cfg = slam.vo_config_from(jcfg)
    assert dataclasses.asdict(cfg) == {
        k: tuple(v) if k == "camera" else v for k, v in dataclasses.asdict(jcfg).items()}
    assert slam.vo_config_from({"seed": 4, "threshold": 20}) == slam.VOConfig(seed=4, threshold=20)


def test_ransac_draws_reproducible():
    a = slam.ransac_draws(3, 2, 8, 16)
    assert a.shape == (2, 8, 16) and a.dtype == torch.float32 and a.device.type == "cpu"
    assert torch.equal(a, slam.ransac_draws(3, 2, 8, 16))
    assert not torch.equal(a, slam.ransac_draws(4, 2, 8, 16))
    assert torch.equal(a[1:], slam.ransac_draws(3, 2, 8, 16)[1:])
