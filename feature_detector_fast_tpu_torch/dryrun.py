"""Entry points: single-device forward step and multi-device dry run.

Counterpart of the repository's ``__graft_entry__.py`` (the JAX package's
``entry`` and ``dryrun_multichip``), for the port: the same steps, shapes,
seeds, configurations and assertions, over a :class:`parallel.mesh.Mesh`
of explicit ``torch.device``s.  One card repeated (``[cuda:0] * 8``) drives
every shard seam through the kernels; ``[cpu] * 8`` runs the plain
versions, as the JAX tests' spoofed 8-device CPU mesh does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import NonmaxMode
from .models import ba, lie, slam
from .ops import fast_cuda
from .parallel import ba_sharded, frontend, mesh as meshlib, pipeline, spatial

#: How far two runs of the dry run's float32 BA step (8 CG steps) may part:
#: absolute on poses and points, relative on the cost.  Two devices, two
#: device-run splits or two packages order the Schur sums differently.
BA_STEP_TOL = {"poses": 1e-4, "points": 1e-3, "cost_rel": 1e-4}

#: The JAX package's row-shard height (``spatial.TILE_H`` there, which is
#: ``fast_pallas.TILE_H_SHARD``): the dry run's frame is n_data of them.
TILE_H = 64


def entry(device=None):
    """(forward, (example,)): the forward step on the flagship model -- the
    dense FAST front-end (detect + score + nonmax, MaxThreshold t=16 n=9)
    on one 1080p frame, ``fdf_fast_dense`` on the card and the plain
    version on the CPU.  ``device`` defaults to the card (raises without
    CUDA)."""
    dev = meshlib.cuda_devices()[0] if device is None else meshlib.device_grid([device])[0]

    def forward(image: torch.Tensor):
        """(mask bool, score u16), both (H, W), of one (H, W) u8 frame."""
        mask, score = fast_cuda.detect_dense(image[None].contiguous(), 16, 9,
                                             NonmaxMode.MAX_THRESHOLD)
        return mask[0].to(torch.bool), score[0]

    example = torch.zeros((1080, 1920), dtype=torch.uint8, device=dev)
    return forward, (example,)


def ba_problem(dev) -> ba.BAProblem:
    """The dry run's 4-camera, 24-point BA problem (seed 0), float32."""
    rng = np.random.default_rng(0)
    n_cams, n_pts = 4, 24
    poses = torch.eye(4, dtype=torch.float32, device=dev).expand(n_cams, 4, 4)
    shifts = torch.as_tensor(rng.normal(0, 0.1, (n_cams, 6)), dtype=torch.float32, device=dev)
    poses = lie.se3_exp(shifts) @ poses
    points = torch.as_tensor(
        np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                  rng.uniform(4, 8, n_pts)], axis=-1), dtype=torch.float32, device=dev)
    cams = torch.as_tensor(np.repeat(np.arange(n_cams), n_pts), device=dev)
    lms = torch.as_tensor(np.tile(np.arange(n_pts), n_cams), device=dev)
    uv = ba.project(poses[cams], points[lms])
    return ba.BAProblem(poses=poses, points=points, obs_cam=cams, obs_lm=lms,
                        obs_uv=uv + 0.001,
                        obs_valid=torch.ones(cams.shape[0], dtype=torch.bool, device=dev),
                        n_fixed_cams=2)


def loop_circuit():
    """The 8-frame open circuit with a loop pair (seed 7): (pair_data,
    loops, ground truth)."""
    rng2 = np.random.default_rng(7)
    f, n_lm = 8, 96
    gtl, T = [np.eye(4)], np.eye(4)
    for _ in range(f - 1):
        # open circuit: frame f-1 one step short of frame 0, so the loop
        # pair keeps a real baseline (a coincident revisit is degenerate)
        xi = np.asarray([0.0, 0.0, 0.45, 0.0, 2 * np.pi / f, 0.0], np.float32)
        T = T @ lie.se3_exp(torch.from_numpy(xi)).numpy()
        gtl.append(T.copy())
    gt = np.stack(gtl)
    pts3 = np.stack([rng2.uniform(-3, 3, n_lm), rng2.uniform(-2, 2, n_lm),
                     rng2.uniform(4, 9, n_lm)], axis=-1)

    def proj(Tw):
        w2c = np.linalg.inv(Tw)
        Xc = pts3 @ w2c[:3, :3].T + w2c[:3, 3]
        z = np.maximum(Xc[:, 2], 1e-6)
        return (Xc[:, :2] / z[:, None] + rng2.normal(0, 5e-4, (n_lm, 2)),
                Xc[:, 2] > 0.1)

    obs = [proj(Tw) for Tw in gt]
    pair_data = [(obs[k][0], obs[k + 1][0], obs[k][1] & obs[k + 1][1])
                 for k in range(f - 1)]
    idx = np.arange(n_lm, dtype=np.int32)
    loops = [(0, f - 1, obs[0][0], obs[f - 1][0], obs[0][1] & obs[f - 1][1], idx)]
    return pair_data, loops, gt


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run the full multi-device pipeline once over an ``n_devices`` mesh
    on tiny shapes, asserting as the JAX dry run does.

    Exercises the real splits end to end:
      * data-parallel FAST front-end: the frame batch split over ``data``,
      * one frame's rows split over ``data`` (halo copies + global-row
        kernels), dense and keypoint-list forms,
      * the 3-stage pipelined front-end when there are 3 devices,
      * distributed bundle adjustment: observations split over ``data``
        (landmarks over ``model`` on a 2-D mesh), the Schur reductions
        summed across shards, CG on the reduced camera system,
      * loop-closing SLAM refinement and sliding-window BA on the mesh.

    ``devices`` defaults to every visible CUDA device (raises without CUDA
    or with fewer than ``n_devices``); it may repeat a device, as
    ``[cuda:0] * 8`` or ``[cpu] * 8``.  Returns the outputs, on the mesh's
    first device, for a caller to compare runs."""
    devs = list(devices) if devices is not None else meshlib.cuda_devices()
    if len(devs) < n_devices:
        raise ValueError(f"dry run over {n_devices} devices, have {len(devs)}")
    devs = devs[:n_devices]
    # 2-D (data x model) mesh when the device count allows: frames split
    # over `data`, BA landmark state over `model`.
    n_model = 2 if (n_devices >= 4 and n_devices % 2 == 0) else 1
    n_data = n_devices // n_model
    mesh = meshlib.make_mesh(n_data=n_data, n_model=n_model, devices=devs)
    dev = mesh.devices_along(meshlib.DATA_AXIS)[0]
    out = {"n_data": n_data, "n_model": n_model}

    # --- front-end: batched detection, the batch split over `data` ---
    batch = n_data  # one tiny frame per data shard
    images = torch.zeros((batch, 32, 128), dtype=torch.uint8)
    shards = frontend.detect_batch_sharded(images, 16, 9, NonmaxMode.MAX_THRESHOLD, mesh=mesh)
    mask, score = frontend.gather(shards, dev)
    assert mask.shape == (batch, 32, 128)
    out["batch_mask"], out["batch_score"] = mask, score

    # --- front-end: one frame's rows split over `data` (halo copies +
    # global-row kernels) ---
    one_frame = torch.zeros((n_data * TILE_H, 128), dtype=torch.uint8)
    smask, sscore = spatial.detect_rows_sharded(one_frame, 16, 9, NonmaxMode.OFF, mesh=mesh)
    assert smask.shape == one_frame.shape
    out["rows_mask"], out["rows_score"] = smask, sscore

    # --- front-end: the row-split KEYPOINT-LIST path (per-shard packed
    # words, decoded on each device).  The JAX path caps each shard at
    # k=8 slots; the port's list has no cap, so it is checked against the
    # dense form instead. ---
    parts = spatial.detect_compact_rows_sharded(one_frame, 16, 9, NonmaxMode.OFF, mesh=mesh)
    pts = torch.cat([p.to(dev) for p in parts])
    assert pts.shape[1:] == (2,) and pts.dtype == torch.int32
    assert torch.equal(pts.flip(1).long(), torch.nonzero(smask))
    out["rows_points"] = pts

    # --- front-end: pipeline parallelism (detect -> describe -> match
    # stages on separate devices and streams) ---
    if n_devices >= pipeline.N_STAGES:
        frames = torch.zeros((4, 32, 128), dtype=torch.uint8)
        stream = pipeline.frontend_pipelined(
            frames, 16, 9, 32, mesh=pipeline.make_pipe_mesh(devs[:pipeline.N_STAGES]))
        assert stream.desc.shape == (4, 32, 8)
        out["pipeline"] = stream

    # --- back-end: one distributed Schur/CG BA step ---
    problem = ba_problem(dev)
    if n_model > 1:
        new_poses, new_points, cost = ba_sharded.ba_step_sharded2d(
            problem, mesh, damping=1e-4, cg_iters=8)
    else:
        # robust_delta exercises the Huber-IRLS path (weights are per
        # observation, so the sharded reductions are unchanged).
        new_poses, new_points, cost = ba_sharded.ba_step_sharded(
            problem, mesh, damping=1e-4, cg_iters=8, robust_delta=0.01)
    assert new_poses.shape == (4, 4, 4)
    assert new_points.shape == (24, 3)
    out["ba_problem"] = problem
    out["ba_step"] = (new_poses, new_points, cost)

    # --- back-end: the loop-closing SLAM refinement ON THE MESH --
    # run_vo_matches(mesh=..., ba_refine=True) with an accepted far-gap
    # loop pair: two-phase loop estimation, rotation averaging over the
    # vetted edge graph, and the global robust (Huber-IRLS) sharded BA
    # rounds. ---
    pair_data, loops, gt = loop_circuit()
    f = gt.shape[0]
    vocfg = slam.VOConfig(ransac_hypotheses=64, pair_refine_iters=2,
                          pair_refine_cg=6, loop_ratio_mad_max=0.6)
    est_mesh = slam.run_vo_matches(list(pair_data), vocfg, loop_pairs=list(loops),
                                   ba_refine=True, mesh=mesh, device=dev)
    assert est_mesh.shape == (f, 4, 4) and np.isfinite(est_mesh).all()
    est_single = slam.run_vo_matches(list(pair_data), vocfg, loop_pairs=list(loops),
                                     ba_refine=True, device=dev)
    a_mesh = slam.evaluate_ate(est_mesh, gt)
    a_single = slam.evaluate_ate(est_single, gt)
    assert np.isfinite(a_mesh), a_mesh
    # distributed refinement must land in the single-device quality class
    assert a_mesh < max(2.0 * a_single, 0.05), (a_mesh, a_single)
    out["ate_mesh"], out["ate_single"] = a_mesh, a_single

    # --- back-end: sliding-window BA, the windows split over the mesh ---
    batch2 = slam._as_pair_batch(pair_data)
    est2 = slam.estimate_pairs(batch2, vocfg, device=dev)
    base = slam.run_vo_matches(list(pair_data), vocfg, device=dev)
    refined = slam.refine_with_ba(base, batch2, est2, mesh=mesh, windowed_threshold=4,
                                  window=4, stride=3, device=dev)
    assert refined.shape == (f, 4, 4) and np.isfinite(refined).all()
    out["ate_windowed"] = slam.evaluate_ate(refined, gt)
    return out


def assert_ba_step_close(got, want) -> None:
    """Hold one (poses, points, cost) BA step to another within BA_STEP_TOL."""
    (p1, x1, c1), (p2, x2, c2) = ([np.asarray(t.detach().cpu()) if isinstance(t, torch.Tensor)
                                   else np.asarray(t) for t in step] for step in (got, want))
    np.testing.assert_allclose(p1, p2, rtol=0, atol=BA_STEP_TOL["poses"])
    np.testing.assert_allclose(x1, x2, rtol=0, atol=BA_STEP_TOL["points"])
    np.testing.assert_allclose(c1, c2, rtol=BA_STEP_TOL["cost_rel"])
