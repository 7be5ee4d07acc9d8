"""The port's two-view geometry against the JAX package, float64.

Scenes are made from a numpy seed; the JAX functions run under the ``x64``
fixture.  The port's functions take leading (P, H) batch dimensions and are
compared with the JAX function vmapped over them.  ``ransac_essential``
gets the JAX package's own draws (``jax.random.uniform`` of its key), so
both sides sample the same hypotheses: the inlier masks must be equal and
E equal up to sign (E and -E are one model) to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.models import twoview as jtv
from feature_detector_fast_tpu_torch.models import twoview

P, H, K = 3, 64, 128


@pytest.fixture(autouse=True)
def _x64(x64):
    yield


def t64(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def rot(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def make_scene(rng, n=K, outliers=0, noise=0.0):
    """Points in front of two cameras with a known relative pose (x_b = R x_a
    + t); the first ``outliers`` correspondences of b are replaced."""
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 10, n)], -1)
    R = rot(rng.normal(0, 0.1, 3))
    t = rng.normal(0, 1, 3)
    t = t / np.linalg.norm(t) * 0.5
    Xb = X @ R.T + t
    pa = X[:, :2] / X[:, 2:3] + rng.normal(0, noise, (n, 2))
    pb = Xb[:, :2] / Xb[:, 2:3] + rng.normal(0, noise, (n, 2))
    pb[:outliers] = rng.uniform(-0.5, 0.5, (outliers, 2))
    return R, t, pa, pb


@pytest.fixture(scope="module")
def scenes():
    """P scenes of K slots, 30 outliers, noise 1e-3, some slots invalid."""
    rng = np.random.default_rng(7)
    out = [make_scene(rng, outliers=30, noise=1e-3) for _ in range(P)]
    valid = rng.random((P, K)) > 0.1
    return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out]),
            np.stack([o[2] for o in out]), np.stack([o[3] for o in out]), valid)


def up_to_sign(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.minimum(np.abs(a - b).max((-2, -1)), np.abs(a + b).max((-2, -1))).max())


def test_camera_and_normalize_points():
    cam = twoview.Camera(300.0, 310.0, 160.0, 120.0)
    jcam = jtv.Camera(300.0, 310.0, 160.0, 120.0)
    assert twoview.camera_from(jcam) == cam
    assert twoview.camera_from(dict(fx=300, fy=310, cx=160, cy=120)) == cam
    np.testing.assert_array_equal(cam.matrix(torch.float64).numpy(), np.asarray(jcam.matrix(jnp.float64)))
    px = np.random.default_rng(0).uniform(0, 320, (5, 7, 2))
    np.testing.assert_allclose(twoview.normalize_points(t64(px), cam).numpy(),
                               np.asarray(jtv.normalize_points(jnp.asarray(px), jcam)), rtol=1e-15)


def test_nullvec_rows8_and_eight_point_hyp(scenes):
    """The unrolled MGS null vector and the hypothesis solve over (P, H)
    minimal samples equal the JAX ones vmapped twice."""
    _, _, pa, pb, _ = scenes
    idx = np.stack([np.stack([np.random.default_rng(h).choice(K, 8, replace=False)
                              for h in range(H)]) for _ in range(P)])
    sa = np.take_along_axis(pa[:, None], idx[..., None], 2)  # (P, H, 8, 2)
    sb = np.take_along_axis(pb[:, None], idx[..., None], 2)
    A = np.asarray(jtv._epipolar_rows(jnp.asarray(sa), jnp.asarray(sb)))
    np.testing.assert_allclose(twoview._epipolar_rows(t64(sa), t64(sb)).numpy(), A, rtol=1e-15)
    want = np.asarray(jax.vmap(jax.vmap(jtv._nullvec_rows8))(jnp.asarray(A)))
    got = twoview._nullvec_rows8(t64(A)).numpy()
    np.testing.assert_allclose(np.abs((got[..., None, :] * A).sum(-1)).max(), 0.0, atol=1e-9)
    np.testing.assert_allclose(got, want, atol=1e-12)
    want_E = np.asarray(jax.vmap(jax.vmap(jtv._eight_point_hyp))(jnp.asarray(sa), jnp.asarray(sb)))
    np.testing.assert_allclose(twoview._eight_point_hyp(t64(sa), t64(sb)).numpy(), want_E,
                               atol=1e-9)


def test_essential_project_and_eigs(rng):
    E = rng.normal(0, 1, (P, H, 3, 3))
    E[0, 0] = np.diag([1.0, 1.0, 0.3])  # equal leading singular values
    got = twoview._essential_project(t64(E)).numpy()
    want = np.asarray(jax.vmap(jax.vmap(jtv._essential_project))(jnp.asarray(E)))
    np.testing.assert_allclose(got, want, atol=1e-10)
    s = np.linalg.svd(got, compute_uv=False)
    np.testing.assert_allclose(s[..., 0], s[..., 1], rtol=1e-8)
    np.testing.assert_allclose(s[..., 2], 0.0, atol=1e-9)
    M = np.swapaxes(E, -1, -2) @ E
    for g, w in zip(twoview._sym3_eigs_smallest(t64(M)),
                    jax.vmap(jax.vmap(jtv._sym3_eigs_smallest))(jnp.asarray(M))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9)


def test_sampson_ray_depths_and_recover_pose(scenes):
    R, t, pa, pb, valid = scenes
    E = np.stack([np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]) @ r
                  for r, v in zip(R, t)])
    got = twoview.sampson_error(t64(E)[:, None], t64(pa)[:, None], t64(pb)[:, None])[:, 0]
    want = jax.vmap(jtv.sampson_error)(jnp.asarray(E), jnp.asarray(pa), jnp.asarray(pb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-18)

    za, zb = twoview.ray_depths(t64(R), t64(t), t64(pa), t64(pb))
    jza, jzb = jax.vmap(jtv.ray_depths)(*(jnp.asarray(x) for x in (R, t, pa, pb)))
    np.testing.assert_allclose(za.numpy(), np.asarray(jza), rtol=1e-10)
    np.testing.assert_allclose(zb.numpy(), np.asarray(jzb), rtol=1e-10)

    gR, gt, gn = twoview.recover_pose(t64(E), t64(pa), t64(pb), torch.from_numpy(valid))
    jR, jt, jn = jax.vmap(jtv.recover_pose)(jnp.asarray(E), jnp.asarray(pa), jnp.asarray(pb),
                                            jnp.asarray(valid))
    np.testing.assert_allclose(gR.numpy(), np.asarray(jR), atol=1e-9)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jt), atol=1e-9)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(gR.numpy(), R, atol=0.05)  # near the truth despite outliers


def test_minimal_samples_tie_order_matches_top_k(rng):
    """With fewer than 8 valid slots the invalid slots' tied 2.0 ranks go
    lowest index first, as jax.lax.top_k(-r, 8) takes them."""
    draws = rng.random((4, H, 40))
    valid = np.zeros((4, 40), bool)
    valid[0, [3, 9, 17]] = True
    valid[1, :5] = True
    valid[2] = True
    valid[3, ::3] = True
    got = twoview.minimal_samples(torch.from_numpy(valid), t64(draws)).numpy()
    r = jnp.where(jnp.asarray(valid)[:, None, :], jnp.asarray(draws), 2.0)
    want = np.asarray(jax.lax.top_k(-r, 8)[1])
    np.testing.assert_array_equal(got, want)


def test_ransac_essential_with_jax_draws(scenes):
    """JAX's draws injected: equal inlier masks, E equal up to sign."""
    R, t, pa, pb, valid = scenes
    keys = jax.random.split(jax.random.PRNGKey(11), P)
    draws = np.stack([np.asarray(jax.random.uniform(k, (H, K))) for k in keys])
    E, inl = twoview.ransac_essential(t64(pa), t64(pb), torch.from_numpy(valid), t64(draws))
    for p in range(P):
        jE, jinl = jtv.ransac_essential(jnp.asarray(pa[p]), jnp.asarray(pb[p]),
                                        jnp.asarray(valid[p]), keys[p], H)
        np.testing.assert_array_equal(inl[p].numpy(), np.asarray(jinl))
        assert up_to_sign(E[p].numpy(), np.asarray(jE)) < 1e-9
    assert (inl.numpy()[:, 30:] | ~valid[:, 30:]).mean() > 0.9  # most true matches are found


def test_eight_point_and_triangulate(rng):
    R, t, pa, pb = make_scene(rng, n=16)
    E = twoview._eight_point(t64(pa), t64(pb))
    assert up_to_sign(E.numpy(), np.asarray(jtv._eight_point(jnp.asarray(pa), jnp.asarray(pb)))) < 1e-9
    assert float(twoview.sampson_error(E, t64(pa), t64(pb)).max()) < 1e-12
    X = twoview.triangulate(t64(np.eye(3)), t64(np.zeros(3)), t64(R), t64(t), t64(pa), t64(pb))
    jX = jtv.triangulate(*(jnp.asarray(x) for x in (np.eye(3), np.zeros(3), R, t, pa, pb)))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=1e-9)
    np.testing.assert_allclose(X.numpy()[:, :2] / X.numpy()[:, 2:], pa, atol=1e-9)
