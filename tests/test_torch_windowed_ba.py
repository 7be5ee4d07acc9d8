"""The port's sliding-window BA against the JAX package, float64.

``build_windows`` and ``stitch_windows`` are host numpy in both packages:
equal outputs.  ``refine_windows`` (one batched ``ba.optimize`` over the
window axis in the port, a vmap in the JAX package) agrees to 1e-10 at 2
iterations of 8 CG steps, under the CG's rounding floor: on these 4-camera
windows one step agrees to 1e-14 at 8 CG steps and parts by up to 7e-3 at
12.  On an 8-device
CPU mesh, and on a mesh of two device runs (``cpu`` and ``cpu:0`` compare
unequal, so the windows split into two batched calls), the windows give the
unsharded result to 1e-12.  Padded observation slots (camera 0, landmark 0,
invalid) leave every segment sum and the step unchanged.
"""

import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.models import windowed_ba as jwindowed
from feature_detector_fast_tpu_torch.models import ba, lie, windowed_ba
from feature_detector_fast_tpu_torch.parallel import mesh as meshlib
from feature_detector_fast_tpu_torch.utils.metrics import ate_rmse
from test_ba import make_ba_problem

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _x64(x64):
    yield


def problem(rng, n_cams=9, n_pts=40, perturb=0.03, noise_px=0.0):
    """(gt poses, host arrays poses / points / obs_cam / obs_lm / obs_uv) of
    the JAX tests' arc problem (tests/test_ba.py make_ba_problem)."""
    gt_poses, _, p = make_ba_problem(rng, n_cams=n_cams, n_pts=n_pts, perturb=perturb,
                                     noise_px=noise_px)
    return gt_poses, tuple(np.asarray(a) for a in (p.poses, p.points, p.obs_cam, p.obs_lm,
                                                     p.obs_uv))


def test_build_windows_matches_jax(rng):
    _, arrays = problem(rng)
    for window, stride in ((4, 3), (4, 4), (5, 2), (12, 3)):
        got = windowed_ba.build_windows(*arrays, window=window, stride=stride)
        want = jwindowed.build_windows(*arrays, window=window, stride=stride)
        for name in windowed_ba.WindowBatch._fields:
            a, b = getattr(got, name), np.asarray(getattr(want, name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert set(got.cam_global.ravel()) == set(range(9))
    with pytest.raises(ValueError, match="stride"):
        windowed_ba.build_windows(*arrays, window=3, stride=4)


def test_stitch_windows_matches_jax():
    """Stitching perturbed windows equals the JAX package's; unperturbed
    windows of a consistent trajectory give it back."""
    rng = np.random.default_rng(1)
    poses, T = [], np.eye(4)
    for _ in range(7):
        T = T @ lie.se3_exp(torch.tensor(rng.normal(0, 0.2, 6))).numpy()
        poses.append(T.copy())
    poses = np.stack(poses)
    cam_global = np.stack([np.arange(0, 4), np.arange(3, 7)])
    windows = np.stack([poses[c] for c in cam_global])
    np.testing.assert_allclose(windowed_ba.stitch_windows(windows, cam_global, 7), poses,
                               atol=1e-10)
    noisy = windows @ np.stack([[lie.se3_exp(torch.tensor(rng.normal(0, 0.05, 6))).numpy()
                                 for _ in range(4)] for _ in range(2)])
    np.testing.assert_array_equal(windowed_ba.stitch_windows(noisy, cam_global, 7),
                                  jwindowed.stitch_windows(noisy, cam_global, 7))


def test_refine_windows_matches_jax(rng):
    """Noisy observations, so the second iteration's acceptance compares
    costs well above the rounding floor (on exact data both iterations'
    costs reach it and the acceptance test compares rounding noise)."""
    _, arrays = problem(rng, noise_px=1e-3)
    wb = windowed_ba.build_windows(*arrays, window=4, stride=3)
    jwb = jwindowed.build_windows(*arrays, window=4, stride=3)
    got_p, got_x = windowed_ba.refine_windows(wb, 2, 8, device="cpu", dtype=torch.float64)
    want_p, want_x = jwindowed.refine_windows(jwb, 2, 8)
    assert got_p.dtype == torch.float64 and got_p.shape == (3, 4, 4, 4)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=1e-10)


@pytest.mark.parametrize("devices,n_runs", [([CPU] * 8, 1),
                                            ([CPU] * 4 + [torch.device("cpu", 0)] * 4, 2)],
                         ids=["one-run", "two-runs"])
def test_refine_windows_on_mesh_matches_unsharded(rng, devices, n_runs):
    """Windows split over the mesh's data devices give the unsharded result
    (each window is its own problem), and the stitched trajectory's ATE
    drops as the JAX test's does (tests/test_windowed_ba.py:61)."""
    gt_poses, arrays = problem(rng)
    wb = windowed_ba.build_windows(*arrays, 4, 3)
    mesh = meshlib.make_mesh(devices=devices)
    assert len(meshlib.device_runs(mesh.devices_along(meshlib.DATA_AXIS))) == n_runs
    r1, _ = windowed_ba.refine_windows(wb, 6, device="cpu", dtype=torch.float64)
    r8, _ = windowed_ba.refine_windows(wb, 6, mesh=mesh, dtype=torch.float64)
    np.testing.assert_allclose(r8.numpy(), r1.numpy(), rtol=0, atol=1e-12)
    s8 = windowed_ba.stitch_windows(r8.numpy(), wb.cam_global, 9)
    ate0 = ate_rmse(arrays[0][:, :3, 3], gt_poses[:, :3, 3])
    assert ate_rmse(s8[:, :3, 3], gt_poses[:, :3, 3]) < 0.3 * ate0


def test_padded_slots_leave_sums_untouched(rng):
    """Appending padded observation slots (camera 0, landmark 0, invalid,
    with garbage coordinates) changes no segment sum and no step; the costs,
    sums over every slot, agree to an ulp (a longer sum rounds in another
    order)."""
    _, arrays = problem(rng, n_cams=5, n_pts=30)
    poses, points, oc, ol, uv = (torch.tensor(a) for a in arrays)
    p = ba.BAProblem(poses, points, oc.long(), ol.long(), uv, torch.ones(len(oc), dtype=torch.bool))
    pad = 13
    padded = p._replace(obs_cam=torch.cat([p.obs_cam, torch.zeros(pad, dtype=torch.int64)]),
                        obs_lm=torch.cat([p.obs_lm, torch.zeros(pad, dtype=torch.int64)]),
                        obs_uv=torch.cat([p.obs_uv, torch.tensor(rng.normal(0, 9, (pad, 2)))]),
                        obs_valid=torch.cat([p.obs_valid, torch.zeros(pad, dtype=torch.bool)]))
    for robust in (0.0, 0.01):
        a, b = ba._build_system(p, 1e-6, robust), ba._build_system(padded, 1e-6, robust)
        for name in ("Hll_inv", "b_c", "b_l"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        *a, ca = ba.ba_step(p, 1e-6, 12, robust_delta=robust)
        *b, cb = ba.ba_step(padded, 1e-6, 12, robust_delta=robust)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        torch.testing.assert_close(ca, cb, rtol=1e-14, atol=0)
    *a, ca = ba.optimize(p, 3, 12, 1e-6)
    *b, cb = ba.optimize(padded, 3, 12, 1e-6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    torch.testing.assert_close(ca, cb, rtol=1e-14, atol=0)


def test_refine_trajectory_windowed_improves_ate(rng):
    gt_poses, arrays = problem(rng, n_pts=50)
    refined = windowed_ba.refine_trajectory_windowed(*arrays, window=4, stride=3, iterations=8,
                                                     device="cpu", dtype=torch.float64)
    want = jwindowed.refine_trajectory_windowed(*arrays, window=4, stride=3, iterations=8)
    ate_before = ate_rmse(arrays[0][:, :3, 3], gt_poses[:, :3, 3])
    ate_after = ate_rmse(refined[:, :3, 3], gt_poses[:, :3, 3])
    assert ate_after < ate_before * 0.3, (ate_before, ate_after)
    assert abs(ate_after - ate_rmse(want[:, :3, 3], gt_poses[:, :3, 3])) < 0.05 * ate_after
