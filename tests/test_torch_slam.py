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
* Structure: ``ba_refine=True`` raises, the TF32 guard restores its flag,
  configurations carry across (``vo_config_from``), the default device is
  CUDA.
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
    with pytest.raises(NotImplementedError, match="refine_with_ba"):
        slam.run_vo_matches([(np.zeros((8, 2)),) * 2 + (np.ones(8, bool),)], slam.VOConfig(),
                            ba_refine=True, device="cpu")
    with pytest.raises(NotImplementedError, match="refine_with_ba"):
        slam.run_vo_images([np.zeros((64, 64), np.uint8)] * 2, slam.VOConfig(), ba_refine=True,
                           device="cpu")
    np.testing.assert_array_equal(slam.run_vo_matches([], slam.VOConfig(), device="cpu"),
                                  np.eye(4)[None])


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
