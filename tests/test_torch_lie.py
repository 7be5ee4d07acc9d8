"""The port's SO(3) / SE(3) operations against the JAX package, float64.

The same seeded tangent vectors go through ``feature_detector_fast_tpu``'s
``models.lie`` (under the ``x64`` fixture) and the port's; results agree to
1e-12.  Gradients at zero come from torch autograd and must be finite and
equal to ``jax.grad``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.models import lie as jlie
from feature_detector_fast_tpu_torch.models import lie

TOL = 1e-12


@pytest.fixture(autouse=True)
def _x64(x64):
    yield


def t64(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def rand_xi(rng, n=16, scale=1.0) -> np.ndarray:
    """(n, 6) tangents: rotations up to ~2 rad, the first one zero and one
    tiny (the Taylor branches)."""
    xi = rng.normal(0, scale, (n, 6))
    xi[0] = 0.0
    xi[1] *= 1e-6
    return xi


@pytest.mark.parametrize("name", ["so3_exp", "se3_exp", "hat"])
def test_exp_and_hat_match_jax(rng, name):
    xi = rand_xi(rng)
    arg = xi[:, 3:] if name != "se3_exp" else xi
    want = np.asarray(getattr(jlie, name)(jnp.asarray(arg)))
    got = getattr(lie, name)(t64(arg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["so3_log", "se3_log"])
def test_log_matches_jax(rng, name):
    xi = rand_xi(rng)
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    arg = T[:, :3, :3] if name == "so3_log" else T
    want = np.asarray(jax.jit(getattr(jlie, name))(jnp.asarray(arg)))
    got = getattr(lie, name)(t64(arg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    back = xi[:, 3:] if name == "so3_log" else xi
    np.testing.assert_allclose(got, back, atol=1e-9)


def test_inverse_compose_apply_match_jax(rng):
    A = np.asarray(jlie.se3_exp(jnp.asarray(rand_xi(rng))))
    B = np.asarray(jlie.se3_exp(jnp.asarray(rand_xi(rng, scale=0.5))))
    p = rng.normal(0, 3, (16, 3))
    cases = [
        (lie.se3_inverse(t64(A)), jlie.se3_inverse(jnp.asarray(A))),
        (lie.se3_compose(t64(A), t64(B)), jlie.se3_compose(jnp.asarray(A), jnp.asarray(B))),
        (lie.se3_apply(t64(A), t64(p)), jlie.se3_apply(jnp.asarray(A), jnp.asarray(p))),
        (lie.vee(lie.hat(t64(p))), jlie.vee(jlie.hat(jnp.asarray(p)))),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose((lie.se3_inverse(t64(A)) @ t64(A)).numpy(),
                               np.broadcast_to(np.eye(4), A.shape), atol=TOL)
    assert torch.equal(lie.se3_identity(torch.float64), torch.eye(4, dtype=torch.float64))


def test_batched_leading_dims(rng):
    """(2, 8, 6) gives the (16, 6) results in the same places."""
    xi = rand_xi(rng)
    flat = lie.se3_exp(t64(xi))
    np.testing.assert_array_equal(lie.se3_exp(t64(xi).reshape(2, 8, 6)).reshape(16, 4, 4).numpy(),
                                  flat.numpy())
    np.testing.assert_allclose(lie.se3_log(flat.reshape(2, 8, 4, 4)).reshape(16, 6).numpy(),
                               xi, atol=1e-9)


@pytest.mark.parametrize("fn,x0", [("se3_exp", np.zeros(6)), ("so3_exp", np.zeros(3)),
                                   ("so3_log", np.eye(3)), ("se3_log", np.eye(4))])
def test_gradients_finite_at_zero(fn, x0):
    """Autograd through exp and log at the identity is finite and equals
    jax.grad (the guarded branches of lie.py:40-61)."""
    # a log's components weighted apart, so the gradient is not symmetric
    weight = np.arange(1.0, 7.0 if fn.startswith("se3") else 4.0) if fn.endswith("log") else 1.0
    x = t64(x0).requires_grad_(True)
    (g,) = torch.autograd.grad((getattr(lie, fn)(x) * torch.as_tensor(weight)).sum(), x)
    assert torch.isfinite(g).all()
    want = jax.jit(jax.grad(lambda y: (getattr(jlie, fn)(y) * weight).sum()))(jnp.asarray(x0))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=TOL)


def test_so3_log_near_pi_mixed_sign_axes(rng):
    """At and near 180 degrees the axis signs come from the symmetric part
    (tests/test_lie.py:79): exp(log(R)) == R, and log equals the JAX
    package's."""
    axes = [np.array([1.0, -1.0, 1.0]) / np.sqrt(3.0), np.array([-1.0, 1.0, 1.0]) / np.sqrt(3.0),
            np.array([0.0, -1.0, 1.0]) / np.sqrt(2.0), np.array([1.0, 0.0, 0.0])]
    for _ in range(8):
        v = rng.normal(0, 1, 3)
        axes.append(v / np.linalg.norm(v))
    w = np.stack([theta * a for a in axes for theta in (np.pi, np.pi - 1e-4, np.pi - 1e-2, 3.0)])
    R = lie.so3_exp(t64(w))
    back = lie.so3_exp(lie.so3_log(R))
    np.testing.assert_allclose(back.numpy(), R.numpy(), atol=5e-4)
    np.testing.assert_allclose(lie.so3_log(R).numpy(),
                               np.asarray(jax.jit(jlie.so3_log)(jnp.asarray(R.numpy()))), atol=1e-9)
