"""The port's descriptor matching on the CPU, against the JAX package.

Hamming distances, match indices and distances are integers, so every
comparison is exact: the tolerance is zero.
"""

import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.models import match as jax_match
from feature_detector_fast_tpu_torch.models import brief, match


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs under pytest-xdist with a worker per core; torch's own
    intra-op thread pool would oversubscribe the cores and slow every
    worker, so these tests run torch single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(rng, k: int) -> np.ndarray:
    """(k, WORDS) random uint32 descriptor words."""
    return rng.integers(0, 2**32, (k, brief.WORDS), dtype=np.uint32)


def t(a: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 bit patterns; other arrays as they are."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def flip_bits(rng, desc: np.ndarray, n_flips: int) -> np.ndarray:
    """desc with n_flips random bits flipped per row."""
    out = desc.copy()
    for row in out:
        for b in rng.choice(brief.BITS, n_flips, replace=False):
            row[b // 32] ^= np.uint32(1 << (b % 32))
    return out


def test_hamming_matrix_matches_popcount_and_jax(rng):
    ka, kb = 17, 23
    da, db = words(rng, ka), words(rng, kb)
    va, vb = rng.random(ka) < 0.8, rng.random(kb) < 0.8
    got = match.hamming_matrix(t(da), t(va), t(db), t(vb)).numpy()
    assert got.dtype == np.int32
    want = np.zeros((ka, kb), np.int32)
    for i in range(ka):
        for j in range(kb):
            want[i, j] = sum(bin(int(da[i, w]) ^ int(db[j, w])).count("1")
                             for w in range(brief.WORDS))
    want[~(va[:, None] & vb[None, :])] = brief.BITS + 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_match.hamming_matrix(da, va, db, vb)))


def test_match_identity(rng):
    """Matching a descriptor set against itself is the identity map."""
    desc = t(words(rng, 32))
    valid = torch.ones(32, dtype=torch.bool)
    m = match.match(desc, valid, desc, valid)
    assert m.idx_b.dtype == torch.int32 and m.dist.dtype == torch.int32
    assert (m.idx_b == torch.arange(32)).all() and (m.dist == 0).all()


@pytest.mark.parametrize("trial", range(4))
def test_match_ties_match_jax(rng, trial):
    """Duplicated descriptors on both sides make exact ties in rows and
    columns; argmin takes the first minimum as jnp.argmin does, so indices,
    distances, the ratio test's second best and the mutual check all equal
    JAX's.  Noisy copies keep distances inside max_dist."""
    base = words(rng, 12)
    da = np.concatenate([base, base[:5], flip_bits(rng, base[:6], 3)])
    db = np.concatenate([flip_bits(rng, base, 2 * trial), base[3:9], base[:2]])
    perm_a, perm_b = rng.permutation(len(da)), rng.permutation(len(db))
    da, db = da[perm_a], db[perm_b]
    va, vb = rng.random(len(da)) < 0.9, rng.random(len(db)) < 0.9
    for kwargs in ({}, {"max_dist": 4, "ratio_num": 1, "ratio_den": 1}):
        got = match.match(t(da), t(va), t(db), t(vb), **kwargs)
        want = jax_match.match(da, va, db, vb, *kwargs.values())
        np.testing.assert_array_equal(got.idx_b.numpy(), np.asarray(want.idx_b))
        np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    d = match.hamming_matrix(t(da), t(va), t(db), t(vb))
    assert (d == d.min(dim=1, keepdim=True).values).sum(dim=1).max() > 1  # ties occurred


def test_match_points_and_batch(rng):
    """match_points equals JAX's; a leading batch dimension equals the pairs
    one by one."""
    k = 24
    da = np.stack([words(rng, k) for _ in range(2)])
    db = np.stack([flip_bits(rng, d[rng.permutation(k)], 5) for d in da])
    va, vb = np.ones((2, k), bool), rng.random((2, k)) < 0.9
    xa = rng.integers(0, 300, (2, k, 2)).astype(np.int32)
    xb = rng.integers(0, 300, (2, k, 2)).astype(np.int32)
    m = match.match(t(da), t(va), t(db), t(vb))
    pa, pb, ok = match.match_points(t(xa), t(xb), m)
    for i in range(2):
        jm = jax_match.match(da[i], va[i], db[i], vb[i])
        np.testing.assert_array_equal(m.idx_b[i].numpy(), np.asarray(jm.idx_b))
        np.testing.assert_array_equal(m.dist[i].numpy(), np.asarray(jm.dist))
        for g, e in zip((pa[i], pb[i], ok[i]), jax_match.match_points(xa[i], xb[i], jm)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    assert int(ok.sum()) > k
