"""The port's pose graph against the JAX package, float64.

A seeded ring graph (noisy odometry, two loop edges, one of them an
outlier for the robust runs) goes through ``feature_detector_fast_tpu``'s
``models.posegraph`` under the ``x64`` fixture and through the port: the
dense and CG solvers, plain and robust, agree on poses and per-iteration
costs to 1e-8; ``rotation_average`` to 1e-9; ``solve_scale_drift`` (numpy
on both sides) to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.models import posegraph as jpg
from feature_detector_fast_tpu_torch.models import lie, posegraph

N = 12


@pytest.fixture(autouse=True)
def _x64(x64):
    yield


def t64(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def exp(xi) -> np.ndarray:
    return lie.se3_exp(t64(xi)).numpy()


def ring(rng, outlier: bool):
    """(JAX PoseGraph, the port's PoseGraph): N poses on a circle, noisy
    odometry integrated as the start, loop edges (N-1, 0) and (0, N/2); with
    ``outlier`` the last is rotated by 2 rad."""
    gt = np.stack([exp([np.cos(a) * 3, np.sin(a) * 3, 0.1 * np.sin(2 * a), 0, 0, a])
                   for a in 2 * np.pi * np.arange(N) / N])
    edges = [(i, i + 1) for i in range(N - 1)] + [(N - 1, 0), (0, N // 2)]
    eT = np.stack([np.linalg.inv(gt[i]) @ gt[j] @ exp(rng.normal(0, 0.01, 6)) for i, j in edges])
    if outlier:
        eT[-1] = eT[-1] @ exp([0, 0, 0, 0, 2.0, 0])
    init = [gt[0]]
    for k in range(N - 1):
        init.append(init[-1] @ eT[k])
    ei = np.array([e[0] for e in edges])
    ej = np.array([e[1] for e in edges])
    valid = np.ones(len(edges), bool)
    w = np.linspace(0.5, 1.5, len(edges))
    arrays = (np.stack(init), ei, ej, eT, valid, w)
    jg = jpg.PoseGraph(*(jnp.asarray(a) for a in arrays))
    tg = posegraph.PoseGraph(t64(arrays[0]), torch.from_numpy(ei), torch.from_numpy(ej),
                             t64(eT), torch.from_numpy(valid), t64(w))
    return gt, jg, tg


def test_edge_residuals_match_jax(rng):
    _, jg, tg = ring(rng, outlier=True)
    np.testing.assert_allclose(posegraph.edge_residuals(tg.poses, tg).numpy(),
                               np.asarray(jpg.edge_residuals(jg.poses, jg)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("robust", [0.0, 0.2])
def test_optimize_matches_jax(rng, solver, robust):
    gt, jg, tg = ring(rng, outlier=robust > 0)
    # 12 CG steps: past ~20 the residual of this 66-rank system reaches the
    # rounding floor, where each step divides rounding noise by rounding
    # noise on both sides and the two runs part (4e-4 at 30 steps).
    poses, costs = posegraph.optimize(tg, 8, solver, 12, 1e-6, robust)
    jposes, jcosts = jpg.optimize(jg, 8, solver, 12, 1e-6, robust)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), rtol=0, atol=1e-8)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-8, atol=1e-14)
    assert float(costs[-1]) < float(costs[0])
    np.testing.assert_array_equal(poses[0].numpy(), tg.poses[0].numpy())  # gauge


def test_solve_scale_drift_matches_jax(rng):
    n = 20
    drift = np.cumsum(rng.normal(0, 0.1, n))
    drift -= drift[0]
    ci, cj = np.nonzero(np.triu(np.ones((n, n)), 5))
    cl = drift[ci] - drift[cj]
    w = rng.uniform(0.5, 1.0, len(ci))
    x = posegraph.solve_scale_drift(n, ci, cj, cl, w)
    np.testing.assert_allclose(x, np.asarray(jpg.solve_scale_drift(n, ci, cj, cl, w)), atol=1e-12)
    assert np.abs(x - drift).max() < 0.05


def test_rotation_average_matches_jax(rng):
    n = 16
    gts = [np.eye(3)]
    for _ in range(n - 1):
        gts.append(gts[-1] @ lie.so3_exp(t64(rng.normal(0, 0.08, 3))).numpy())
    gts = np.stack(gts)
    init = np.stack([lie.so3_exp(t64(rng.normal(0, 0.05, 3) * k / n)).numpy() @ g
                     for k, g in enumerate(gts)])
    ei = np.array(list(range(n - 1)) + [0, 2, 5, 1])
    ej = np.array(list(range(1, n)) + [n - 1, n - 3, n - 2, n - 5])
    eR = np.stack([gts[i].T @ gts[j] for i, j in zip(ei, ej)])
    eR[-1] = eR[-1] @ lie.so3_exp(t64([np.pi / 2, 0, 0])).numpy()  # an outlier edge
    ew = np.ones(len(ei))
    got = posegraph.rotation_average(t64(init), torch.from_numpy(ei), torch.from_numpy(ej), t64(eR),
                                     t64(ew))
    want = jpg.rotation_average(jnp.asarray(init), jnp.asarray(ei, jnp.int32),
                                jnp.asarray(ej, jnp.int32), jnp.asarray(eR), jnp.asarray(ew))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-9)
    err = np.linalg.norm(lie.so3_log(got @ t64(gts).transpose(-1, -2)).numpy()
                         - lie.so3_log(got[:1] @ t64(gts[:1]).transpose(-1, -2)).numpy(), axis=1)
    assert err.max() < 0.03
