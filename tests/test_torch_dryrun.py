"""The port's dry run (``dryrun.py``) against the JAX package's entry points.

``entry(device="cpu")``'s forward step equals the JAX ``__graft_entry__``
forward bit for bit on a seeded random 1080p frame.  ``dryrun_multichip(8)``
runs on ``[cpu] * 8`` (one device run) and on ``[cpu] * 4 + [cpu:0] * 4``
(two runs: ``ba_sharded``'s threads and the forward-AD lock), its own
assertions hold, and the two runs agree: the front-end bit for bit, the
float32 BA step within ``dryrun.BA_STEP_TOL`` (poses 1e-4, points 1e-3,
cost relative 1e-4: the two splits order the Schur sums differently).
Its BA step equals the JAX package's ``ba_step_sharded2d`` of the same
problem (numpy arrays) on the conftest's 8-device CPU mesh within the same
tolerance, and its single-device loop refinement lands within the dry
run's own gate of the JAX package's.  The JAX dry run itself (``__graft_entry__.dryrun_multichip``) is tests/test_parallel.py's,
marked slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from feature_detector_fast_tpu.models import ba as jba
from feature_detector_fast_tpu.models import slam as jslam
from feature_detector_fast_tpu.parallel import ba_sharded as jba_sharded
from feature_detector_fast_tpu.parallel import mesh as jmesh
from feature_detector_fast_tpu_torch import dryrun

CPU = torch.device("cpu")
MIXED = [CPU] * 4 + [torch.device("cpu", 0)] * 4


def test_entry_forward_matches_jax():
    fn, (example,) = dryrun.entry(device="cpu")
    assert example.shape == (1080, 1920) and example.dtype == torch.uint8
    assert example.device == CPU and not example.any()
    jfn, (jexample,) = ge.entry()
    assert jexample.shape == tuple(example.shape)
    frame = np.random.default_rng(11).integers(0, 256, (1080, 1920), np.uint8)
    mask, score = fn(torch.from_numpy(frame))
    jmask, jscore = jax.jit(jfn)(jnp.asarray(frame))
    assert mask.dtype == torch.bool and score.dtype == torch.uint16
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    assert int(mask.sum()) > 0
    zmask, zscore = fn(example)
    assert not zmask.any() and not zscore.any()


def test_entry_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is chip_smoke.py's")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(8)


@pytest.fixture(scope="module")
def runs():
    """The dry run on one device run and on two."""
    return {"one-run": dryrun.dryrun_multichip(8, [CPU] * 8),
            "two-runs": dryrun.dryrun_multichip(8, MIXED)}


@pytest.mark.parametrize("name", ["one-run", "two-runs"])
def test_dryrun_multichip_cpu(runs, name):
    out = runs[name]
    assert (out["n_data"], out["n_model"]) == (4, 2)
    assert out["batch_mask"].shape == (4, 32, 128) and not out["batch_mask"].any()
    assert out["rows_mask"].shape == (4 * dryrun.TILE_H, 128)
    assert out["rows_points"].shape == (0, 2)
    assert out["pipeline"].desc.shape == (4, 32, 8)
    poses, points, cost = out["ba_step"]
    assert poses.shape == (4, 4, 4) and points.shape == (24, 3) and torch.isfinite(cost)
    assert out["ate_mesh"] < max(2.0 * out["ate_single"], 0.05)
    assert np.isfinite(out["ate_windowed"])


def test_dryrun_runs_agree(runs):
    a, b = runs["one-run"], runs["two-runs"]
    for key in ("batch_mask", "batch_score", "rows_mask", "rows_score", "rows_points"):
        assert torch.equal(a[key], b[key]), key
    for x, y in zip(a["pipeline"], b["pipeline"]):
        assert torch.equal(x, y)
    dryrun.assert_ba_step_close(b["ba_step"], a["ba_step"])


def test_dryrun_ba_step_matches_jax_sharded2d(runs):
    """The dry run's step against the JAX package's ``ba_step_sharded2d``
    of the same problem, as numpy arrays, on the conftest's 8-device mesh."""
    p = runs["one-run"]["ba_problem"]
    jm = jmesh.make_mesh(n_data=4, n_model=2, devices=jax.devices()[:8])

    @jax.jit  # one program: the eager shard_map takes ten times longer here
    def step(*arrays):
        jp = jba.BAProblem(*arrays, n_fixed_cams=p.n_fixed_cams)
        return jba_sharded.ba_step_sharded2d(jp, jm, damping=1e-4, cg_iters=8)

    want = step(jnp.asarray(p.poses.numpy()), jnp.asarray(p.points.numpy()),
                jnp.asarray(p.obs_cam.numpy(), jnp.int32), jnp.asarray(p.obs_lm.numpy(), jnp.int32),
                jnp.asarray(p.obs_uv.numpy()), jnp.asarray(p.obs_valid.numpy()))
    got = runs["one-run"]["ba_step"]
    assert all(t.dtype == torch.float32 for t in got)
    dryrun.assert_ba_step_close(got, want)


def test_dryrun_loop_refinement_in_the_jax_quality_class(runs):
    """The single-device loop refinement of the dry run's circuit, port
    against the JAX package (each with its own RANSAC draws), under the dry
    run's own mesh gate: a_port < max(2 a_jax, 0.05)."""
    pair_data, loops, gt = dryrun.loop_circuit()
    cfg = jslam.VOConfig(ransac_hypotheses=64, pair_refine_iters=2, pair_refine_cg=6,
                         loop_ratio_mad_max=0.6)
    est = jslam.run_vo_matches(list(pair_data), cfg, loop_pairs=list(loops), ba_refine=True)
    a_jax = jslam.evaluate_ate(np.asarray(est), gt)
    assert runs["one-run"]["ate_single"] < max(2.0 * a_jax, 0.05), (
        runs["one-run"]["ate_single"], a_jax)
