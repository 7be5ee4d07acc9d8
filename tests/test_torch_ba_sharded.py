"""The port's distributed bundle adjustment on CPU meshes, float64.

The counterpart of tests/test_ba_sharded.py: ``ba_step_sharded`` on
``make_mesh(devices=[cpu] * 8)`` against the port's single-device
``ba.ba_step`` and against the JAX package's ``ba_step_sharded`` on its
spoofed 8-device mesh; a non-divisible observation count; the 2-D (4 x 2)
step with landmarks split over the model axis; the Huber-IRLS step in 1-D
and 2-D; ``optimize_sharded`` converging.  A mesh of ``cpu`` and ``cpu:0``
(unequal devices) holds two device runs, so the threaded all-reduce runs
too.  Summation order differs from the single-device step, so the
agreement is to a tolerance.  The steps run 8 CG steps, under the CG's
rounding floor on these problems, and agree to 1e-10 (poses; measured
2e-14): at 12 steps and beyond, where the JAX tests run (30, 80), the
reduced system's near-null directions amplify the order of the sums, and
the sharded and single-device steps part by up to 2e-2 in float64.
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.models import ba as jba
from feature_detector_fast_tpu.parallel import ba_sharded as jba_sharded
from feature_detector_fast_tpu.parallel import mesh as jmesh
from feature_detector_fast_tpu_torch.models import ba
from feature_detector_fast_tpu_torch.parallel import ba_sharded, mesh as meshlib
from test_ba import make_ba_problem

CPU = torch.device("cpu")
#: Two device runs on the CPU: "cpu" and "cpu:0" compare unequal.
MIXED = [CPU] * 4 + [torch.device("cpu", 0)] * 4


@pytest.fixture(autouse=True)
def _x64(x64):
    yield


def problem(rng, n_cams=5, n_pts=40, drop=0, outliers=False):
    """(JAX BAProblem, the port's BAProblem) of make_ba_problem's arrays,
    without the last ``drop`` observations, with every 17th observation
    moved 0.3 off where ``outliers``."""
    _, _, jp = make_ba_problem(rng, n_cams=n_cams, n_pts=n_pts)
    o = int(jp.obs_cam.shape[0]) - drop
    uv = np.asarray(jp.obs_uv)[:o].copy()
    if outliers:
        uv[::17] += 0.3
    jp = jba.BAProblem(jp.poses, jp.points, jp.obs_cam[:o], jp.obs_lm[:o], jnp.asarray(uv),
                       jp.obs_valid[:o], jp.n_fixed_cams)
    tp = ba.BAProblem(*(torch.from_numpy(np.array(a)) for a in jp[:6]), jp.n_fixed_cams)
    return jp, tp._replace(obs_cam=tp.obs_cam.long(), obs_lm=tp.obs_lm.long())


#: CG steps under the rounding floor of these problems.
CG = 8


def assert_step_close(got, want, pose_tol=1e-10, point_tol=1e-9, cost_rtol=1e-12):
    (p1, x1, c1), (p2, x2, c2) = got, want
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), rtol=cost_rtol)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), rtol=0, atol=pose_tol)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), rtol=0, atol=point_tol)


@pytest.mark.parametrize("devices", [[CPU] * 8, MIXED], ids=["one-run", "two-runs"])
def test_sharded_step_matches_single_device(rng, devices):
    jp, p = problem(rng)
    mesh = meshlib.make_mesh(devices=devices)
    got = ba_sharded.ba_step_sharded(p, mesh, 1e-6, CG)
    assert got[0].shape == (5, 4, 4) and got[1].shape == (40, 3) and got[2].shape == ()
    assert_step_close(got, ba.ba_step(p, 1e-6, CG))
    assert_step_close(got, jba.ba_step(jp, 1e-6, CG))


def test_sharded_handles_nondivisible_observation_count(rng):
    _, p = problem(rng, n_pts=30, drop=5)
    assert p.obs_cam.shape[0] % 8 != 0
    padded = ba_sharded.pad_observations(p, 8)
    assert padded.obs_cam.shape[0] % 8 == 0 and not padded.obs_valid[-1]
    got = ba_sharded.ba_step_sharded(p, meshlib.make_mesh(devices=[CPU] * 8), 1e-6, CG)
    assert_step_close(got, ba.ba_step(p, 1e-6, CG))


@pytest.mark.parametrize("devices", [[CPU] * 8, MIXED], ids=["one-run", "two-runs"])
def test_sharded2d_matches_single_device(rng, devices):
    """Observations over 4 data shards, 37 landmarks over 2 model shards
    (both padded), as tests/test_ba_sharded.py:91."""
    jp, p = problem(rng, n_pts=37, drop=5)
    mesh = meshlib.make_mesh(n_data=4, n_model=2, devices=devices)
    got = ba_sharded.ba_step_sharded2d(p, mesh, 1e-6, CG)
    assert got[1].shape == (37, 3)
    assert_step_close(got, ba.ba_step(p, 1e-6, CG))
    assert_step_close(got, jba.ba_step(jp, 1e-6, CG))


@pytest.mark.slow
def test_sharded_steps_match_jax_sharded(rng):
    """The 1-D and 2-D steps against the JAX package's ``shard_map`` steps on
    its spoofed 8-device mesh.  Slow: the two shard_map programs take ~165 s
    to compile on the CPU."""
    jp, p = problem(rng)
    assert_step_close(ba_sharded.ba_step_sharded(p, meshlib.make_mesh(devices=[CPU] * 8), 1e-6, CG),
                      jba_sharded.ba_step_sharded(jp, jmesh.make_mesh(), 1e-6, CG))
    jp, p = problem(rng, n_pts=37, drop=5)
    assert_step_close(
        ba_sharded.ba_step_sharded2d(p, meshlib.make_mesh(4, 2, devices=[CPU] * 8), 1e-6, CG),
        jba_sharded.ba_step_sharded2d(jp, jmesh.make_mesh(n_data=4, n_model=2), 1e-6, CG))


def test_sharded_robust_matches_single_device(rng):
    """Huber IRLS with gross outliers: the 1-D and 2-D steps against the
    single-device robust step (tests/test_ba_sharded.py:115's problem)."""
    jp, p = problem(rng, n_pts=37, outliers=True)
    want = ba.ba_step(p, 1e-6, CG, robust_delta=0.01)
    assert_step_close(want, jba.ba_step(jp, 1e-6, CG, robust_delta=0.01))
    got1 = ba_sharded.ba_step_sharded(p, meshlib.make_mesh(devices=[CPU] * 8), 1e-6, CG,
                                      robust_delta=0.01)
    assert_step_close(got1, want)
    got2 = ba_sharded.ba_step_sharded2d(p, meshlib.make_mesh(4, 2, devices=[CPU] * 8), 1e-6, CG,
                                        robust_delta=0.01)
    assert_step_close(got2, want)


@pytest.mark.parametrize("devices", [[CPU] * 8, MIXED], ids=["one-run", "two-runs"])
def test_sharded_optimize_converges(rng, devices):
    gt_poses, _, jp = make_ba_problem(rng, n_cams=5, n_pts=40)
    p = ba.BAProblem(*(torch.from_numpy(np.array(a)) for a in jp[:6]), jp.n_fixed_cams)
    p = p._replace(obs_cam=p.obs_cam.long(), obs_lm=p.obs_lm.long())
    c0 = float(ba.total_cost(p))
    poses, points, costs = ba_sharded.optimize_sharded(p, 10, 30, 1e-6,
                                                       mesh=meshlib.make_mesh(devices=devices))
    assert costs.shape == (10,) and float(costs[-1]) < c0 * 1e-6
    assert np.abs(poses.numpy() - gt_poses).max() < 1e-3
    single, _, _ = ba.optimize(p, 10, 30, 1e-6)
    np.testing.assert_allclose(poses.numpy(), single.numpy(), rtol=0, atol=1e-6)


def test_sharded_f32_cost_agreement(rng):
    """float32: both steps reach the same cost basin (rtol 1e-4, as
    tests/test_ba_sharded.py:46 holds the JAX package), at 6 CG steps: in
    float32 the floor comes sooner (at 30 steps the costs part by 1e-3)."""
    _, p = problem(rng)
    p = p._replace(**{f: getattr(p, f).float() for f in ("poses", "points", "obs_uv")})
    c0 = float(ba.total_cost(p))
    p1, x1, _ = ba.ba_step(p, 1e-6, 6)
    p8, x8, _ = ba_sharded.ba_step_sharded(p, meshlib.make_mesh(devices=MIXED), 1e-6, 6)
    c1 = float(ba.total_cost(p._replace(poses=p1, points=x1)))
    c8 = float(ba.total_cost(p._replace(poses=p8, points=x8)))
    assert p8.dtype == torch.float32 and c1 < 0.5 * c0 and c8 < 0.5 * c0
    np.testing.assert_allclose(c8, c1, rtol=1e-4)


def test_thread_failure_raises(rng, monkeypatch):
    """A run that fails inside its thread breaks the barrier for the others
    and the caller sees its error, not a hang."""
    _, p = problem(rng)
    step = ba.ba_step.__wrapped__
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("the first run fails")
        return step(*args, **kwargs)

    monkeypatch.setattr(ba.ba_step, "__wrapped__", failing)
    with pytest.raises(ValueError, match="the first run fails"):
        ba_sharded.ba_step_sharded(p, meshlib.make_mesh(devices=MIXED), 1e-6, 4)
    assert len(calls) == 2


def test_all_reduce_stress():
    """16 threads (more than this machine's cores) each all-reduce 200
    tensors with the interpreter switching every microsecond: every call
    returns the sum of that call's parts (a lost or overwritten part would
    break it), and every thread ends."""
    n, calls = 16, 200
    reduce = ba_sharded._AllReduce(n, CPU)
    got = [[] for _ in range(n)]

    def worker(rank):
        for c in range(calls):
            got[rank].append(float(reduce(rank, torch.tensor(float(rank + n * c)))))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    want = [sum(r + n * c for r in range(n)) for c in range(calls)]
    assert all(g == want for g in got)
