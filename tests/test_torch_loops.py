"""Loop proposal against the JAX package, on the CPU: the frame signatures
(the pre-gate that makes the 128- and 256-frame evaluations affordable),
``propose_loop_closures`` exhaustive and signature-gated on a rendered
two-lap circuit, and the rendered circuit's reuse (``vo_bench.sequence(2n)``
begins with ``sequence(n)``).

Both packages get the same features (the port's, bit-exact with the JAX
package's front-end: tests/test_torch_slam.py), so what is compared is the
proposal alone: the same (i, j) pairs, the same matched slots (validity and
idx_b exactly), normalized points within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.models import slam as jslam
from feature_detector_fast_tpu_torch.models import slam
from feature_detector_fast_tpu_torch.tools import vo_bench

FRAMES, WIDTH, HEIGHT, K = 16, 320, 240, 128


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def circuit():
    """16 frames of a two-lap 320 x 240 circuit (vo_bench's scene), the
    port's features at K=128 and both packages' VOConfig."""
    gt, frames = vo_bench.sequence(FRAMES, WIDTH, HEIGHT, workers=1, laps=2)
    cfg = vo_bench.vo_config(FRAMES, vo_bench.render_config(WIDTH, HEIGHT).camera(), K)
    feats = slam.frontend_features(frames, cfg, device="cpu")
    jcfg = jslam.VOConfig(max_keypoints=K, camera=cfg.camera)
    jfeats = (jnp.asarray(feats[0].numpy()), jnp.asarray(feats[1].numpy().view(np.uint32)),
              jnp.asarray(feats[2].numpy()))
    return frames, cfg, feats, jcfg, jfeats


def test_frame_signatures_match_jax():
    """(F, 256) mean bits over the valid slots: integer sums over one
    count, so equal exactly; a frame without valid slots gives zeros."""
    rng = np.random.default_rng(7)
    desc = rng.integers(0, 2 ** 32, (5, 33, 8), dtype=np.uint64).astype(np.uint32)
    valid = rng.random((5, 33)) < 0.6
    valid[3] = False
    got = slam._frame_signatures(torch.from_numpy(desc.view(np.int32)),
                                 torch.from_numpy(valid)).numpy()
    want = np.asarray(jslam._frame_signatures(jnp.asarray(desc), jnp.asarray(valid)))
    assert got.shape == (5, 256) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not got[3].any()
    bit = (desc[0, :, 2] >> 5) & 1
    assert got[0, 2 * 32 + 5] == np.float32(bit[valid[0]].mean())


def _same_proposals(got, want):
    assert [(g[0], g[1]) for g in got] == [(int(w[0]), int(w[1])) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[4], np.asarray(w[4]))  # matched slots
        np.testing.assert_array_equal(g[5][g[4]], np.asarray(w[5])[g[4]])  # idx_b there
        np.testing.assert_allclose(g[2][g[4]], np.asarray(w[2])[g[4]], rtol=0, atol=1e-6)
        np.testing.assert_allclose(g[3][g[4]], np.asarray(w[3])[g[4]], rtol=0, atol=1e-6)


@pytest.mark.parametrize("top_k", [0, 8], ids=["exhaustive", "top_k=8"])
def test_propose_loop_closures_matches_jax(circuit, top_k):
    """gap 4 (frame 0 has 12 partners, so top_k=8 ranks), first with
    min_matches 0 (every candidate), then at the median match count, which
    keeps some loops and drops others."""
    frames, cfg, feats, jcfg, jfeats = circuit
    kw = dict(gap=4, top_k=top_k)
    every = slam.propose_loop_closures(frames, cfg, min_matches=0, features=feats,
                                       device="cpu", **kw)
    _same_proposals(every, jslam.propose_loop_closures(frames, jcfg, min_matches=0,
                                                       features=jfeats, **kw))
    n_cand = sum(FRAMES - i - 4 for i in range(FRAMES - 4))
    assert len(every) == (n_cand if not top_k else
                          sum(min(8, FRAMES - i - 4) for i in range(FRAMES - 4)))
    counts = sorted(int(e[4].sum()) for e in every)
    min_matches = counts[len(counts) // 2]
    kept = slam.propose_loop_closures(frames, cfg, min_matches=min_matches, features=feats,
                                      device="cpu", **kw)
    assert 0 < len(kept) < len(every)
    assert all(int(e[4].sum()) >= min_matches for e in kept)
    _same_proposals(kept, jslam.propose_loop_closures(frames, jcfg, min_matches=min_matches,
                                                      features=jfeats, **kw))


def test_sequence_prefix_is_the_shorter_circuit():
    """At 64 frames a lap, sequence(128)'s first 64 poses and frames are
    sequence(64)'s, bit for bit (the scale evaluation renders once and
    slices)."""
    gt64, f64 = vo_bench.sequence(64, 64, 48, workers=1)
    gt128, f128 = vo_bench.sequence(128, 64, 48, workers=1)
    np.testing.assert_array_equal(gt128[:64], gt64)
    assert all(np.array_equal(a, b) for a, b in zip(f128[:64], f64))
    np.testing.assert_allclose(gt128[64], gt128[0], atol=1e-12)  # a lap later
