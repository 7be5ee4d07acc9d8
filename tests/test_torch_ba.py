"""The port's bundle adjustment against the JAX package, float64.

One seeded problem (C=4 cameras on an arc, L=60 landmarks, the first two
cameras fixed for the gauge, perturbed starts, some observations invalid)
goes through ``feature_detector_fast_tpu.models.ba`` under the ``x64``
fixture and through the port: ``_inv33`` and the Jacobians agree to 1e-12,
``ba_step`` and ``optimize`` to 1e-8.  The port also takes a leading batch
of problems (``slam.estimate_pairs`` refines every pair at once), which
must give each problem's own result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.models import ba as jba
from feature_detector_fast_tpu.models import lie as jlie
from feature_detector_fast_tpu_torch.models import ba

C, L = 4, 60


@pytest.fixture(autouse=True)
def _x64(x64):
    yield


def t64(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def make_problem(seed: int, noise: float = 1e-3):
    """(JAX BAProblem, the port's BAProblem) of the same arrays."""
    rng = np.random.default_rng(seed)
    gt = []
    for i in range(C):
        xi = np.zeros(6)
        xi[0] = -i * 0.5
        xi[4] = 0.05 * np.sin(i)
        gt.append(np.asarray(jlie.se3_exp(jnp.asarray(xi))))
    gt = np.stack(gt)
    pts = np.stack([rng.uniform(-1, C * 0.5 + 1, L), rng.uniform(-2, 2, L),
                    rng.uniform(5, 9, L)], -1)
    cams = np.repeat(np.arange(C), L).astype(np.int32)
    lms = np.tile(np.arange(L), C).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", gt[cams, :3, :3], pts[lms]) + gt[cams, :3, 3]
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, noise, (len(cams), 2))
    valid = rng.random(len(cams)) > 0.1
    poses0 = gt.copy()
    for i in range(2, C):
        poses0[i] = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.05, 6)))) @ poses0[i]
    pts0 = pts + rng.normal(0, 0.2, pts.shape)
    arrays = (poses0, pts0, cams, lms, uv, valid)
    jp = jba.BAProblem(*(jnp.asarray(a) for a in arrays), n_fixed_cams=2)
    tp = ba.BAProblem(t64(poses0), t64(pts0), torch.from_numpy(cams).long(),
                      torch.from_numpy(lms).long(), t64(uv), torch.from_numpy(valid),
                      n_fixed_cams=2)
    return jp, tp


@pytest.fixture()
def problem(_x64):
    """Built under x64 (a wider-scoped fixture would make float32 JAX
    arrays)."""
    return make_problem(3)


def test_inv33_matches_jax(rng):
    A = rng.normal(0, 1, (50, 3, 3))
    M = np.swapaxes(A, -1, -2) @ A + 1e-3 * np.eye(3)
    got = ba._inv33(t64(M)).numpy()
    np.testing.assert_allclose(got, np.asarray(jba._inv33(jnp.asarray(M))), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got @ M, np.broadcast_to(np.eye(3), M.shape), atol=1e-8)


@pytest.mark.parametrize("robust", [0.0, 5e-3])
def test_jacobians_match_jax_jacfwd(problem, robust):
    jp, tp = problem
    want = jax.jit(jba._jacobians, static_argnums=1)(jp, robust)  # one compile, not op by op
    for got, want in zip(ba._jacobians(tp, robust), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_ba_step_matches_jax(problem):
    jp, tp = problem
    got = ba.ba_step(tp, 1e-4, 30)
    want = jax.jit(jba.ba_step, static_argnums=2)(jp, 1e-4, 30)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-8)
    # the psum hooks: identity reductions change nothing
    same = ba.ba_step(tp, 1e-4, 30, psum=lambda x: x)
    for g, s in zip(got, same):
        np.testing.assert_allclose(s.numpy(), g.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("robust", [0.0, 5e-3])
def test_optimize_matches_jax(problem, robust):
    jp, tp = problem
    poses, points, costs = ba.optimize(tp, 4, 30, 1e-4, robust)
    jposes, jpoints, jcosts = jba.optimize(jp, 4, 30, 1e-4, robust)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), rtol=0, atol=1e-8)
    np.testing.assert_allclose(points.numpy(), np.asarray(jpoints), rtol=0, atol=1e-8)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-8, atol=1e-14)
    assert costs[-1] < 0.1 * float(ba.total_cost(tp, robust))
    np.testing.assert_array_equal(poses[:2].numpy(), tp.poses[:2].numpy())  # gauge cameras fixed
    np.testing.assert_allclose(float(ba.total_cost(tp, robust)),
                               float(jba.total_cost(jp, robust)), rtol=1e-12)


def test_batched_problems_match_each_alone():
    """Two problems stacked on a leading dimension, over shared observation
    indices, give each problem's own optimize result."""
    _, a = make_problem(5)
    _, b = make_problem(6)
    stacked = ba.BAProblem(torch.stack([a.poses, b.poses]), torch.stack([a.points, b.points]),
                           a.obs_cam, a.obs_lm, torch.stack([a.obs_uv, b.obs_uv]),
                           torch.stack([a.obs_valid, b.obs_valid]), n_fixed_cams=2)
    poses, points, costs = ba.optimize(stacked, 3, 20, 1e-4)
    assert costs.shape == (3, 2)
    for i, p in enumerate((a, b)):
        pi, xi, ci = ba.optimize(p, 3, 20, 1e-4)
        np.testing.assert_allclose(poses[i].numpy(), pi.numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(points[i].numpy(), xi.numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(costs[:, i].numpy(), ci.numpy(), rtol=1e-10)
