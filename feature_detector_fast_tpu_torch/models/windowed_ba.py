"""Sliding-window bundle adjustment, windows split over a device mesh.

Counterpart of ``feature_detector_fast_tpu.models.windowed_ba``.  A long
trajectory is cut into overlapping windows of W cameras; each window is an
independent local BA problem, so the windows refine together as one
batched ``ba.optimize`` call (the window is the problem's leading batch
dimension, with per-window step acceptance).  With a mesh, the windows split
over the mesh's data devices, one batched call per run of consecutive
shards on one device (``parallel.mesh.device_runs``), as
``parallel.frontend`` splits frames.  The refined windows are stitched back
into one trajectory by anchoring each window at its first camera shared
with the ones before it.

Window extraction and stitching run on the host in numpy (ragged
bookkeeping), giving fixed-capacity batched arrays with validity bits:
padded observation slots are (camera 0, landmark 0, invalid), whose
residuals and Jacobians are masked to zero, so they add nothing to the
segment sums.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..api import _device
from ..parallel import mesh as meshlib
from . import ba as ba_lib


class WindowBatch(NamedTuple):
    """Batched fixed-capacity window problems (leading axis = window), host
    arrays."""

    poses: np.ndarray  # (N, W, 4, 4)
    points: np.ndarray  # (N, Lcap, 3)
    obs_cam: np.ndarray  # (N, Ocap) local camera index
    obs_lm: np.ndarray  # (N, Ocap) local landmark index
    obs_uv: np.ndarray  # (N, Ocap, 2)
    obs_valid: np.ndarray  # (N, Ocap)
    cam_global: np.ndarray  # (N, W) global camera index of each slot


def build_windows(poses: np.ndarray, points: np.ndarray, obs_cam: np.ndarray,
                  obs_lm: np.ndarray, obs_uv: np.ndarray, window: int,
                  stride: int) -> WindowBatch:
    """Cut a trajectory-wide BA problem into overlapping windows."""
    if stride > window:
        raise ValueError(f"stride ({stride}) > window ({window}) leaves cameras outside every "
                         "window; stitch_windows requires full coverage")
    n_cams = poses.shape[0]
    starts = list(range(0, max(n_cams - window, 0) + 1, stride))
    if starts and starts[-1] + window < n_cams:
        starts.append(n_cams - window)
    if not starts:
        starts = [0]

    per_window = []
    l_cap = o_cap = 0
    for s in starts:
        cams = np.arange(s, min(s + window, n_cams))
        in_w = np.isin(obs_cam, cams)
        lms = np.unique(obs_lm[in_w])
        per_window.append((cams, lms, np.nonzero(in_w)[0]))
        l_cap = max(l_cap, len(lms))
        o_cap = max(o_cap, in_w.sum())

    sel_pts, sel_cam, sel_lm, sel_uv, sel_valid, cam_globals = [], [], [], [], [], []
    for cams, lms, oidx in per_window:
        lmap = {g: i for i, g in enumerate(lms)}
        cmap = {g: i for i, g in enumerate(cams)}
        oc = np.array([cmap[c] for c in obs_cam[oidx]], np.int32)
        ol = np.array([lmap[g] for g in obs_lm[oidx]], np.int32)
        pad_o = o_cap - len(oidx)
        sel_cam.append(np.pad(oc, (0, pad_o)))
        sel_lm.append(np.pad(ol, (0, pad_o)))
        sel_uv.append(np.pad(obs_uv[oidx], ((0, pad_o), (0, 0))))
        sel_valid.append(np.pad(np.ones(len(oidx), bool), (0, pad_o)))
        sel_pts.append(np.pad(points[lms], ((0, l_cap - len(lms)), (0, 0))))
        cam_globals.append(cams)

    return WindowBatch(
        poses=np.stack([poses[c] for c in cam_globals]),
        points=np.stack(sel_pts),
        obs_cam=np.stack(sel_cam),
        obs_lm=np.stack(sel_lm),
        obs_uv=np.stack(sel_uv),
        obs_valid=np.stack(sel_valid),
        cam_global=np.stack(cam_globals),
    )


def refine_windows(wb: WindowBatch, iterations: int = 6, cg_iters: int = 20,
                   damping: float = 1e-6, *, mesh: Optional[meshlib.Mesh] = None,
                   device="cuda", dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local BA of every window, each window's first camera its gauge.

    Without a mesh: one batched ``ba.optimize`` on ``device``.  With one,
    shard i of the data axis takes the i-th of its len(devices) consecutive
    slices of the windows (the first N % len(devices) one window longer),
    and each run of consecutive shards on one device is one batched call.
    Returns (poses (N, W, 4, 4), points (N, Lcap, 3)) in ``dtype`` on
    ``device`` or the mesh's first device."""
    n = wb.poses.shape[0]
    if mesh is None:
        runs, start = [(_device(device), 0, 1)], [0, n]
    else:
        devices = mesh.devices_along(meshlib.DATA_AXIS)
        s = len(devices)
        runs = meshlib.device_runs(devices)
        start = np.concatenate([[0], np.cumsum([n // s + (i < n % s) for i in range(s)])])
    out_poses, out_points = [], []
    for dev, first, m in runs:
        lo, hi = int(start[first]), int(start[first + m])
        if hi == lo:
            continue

        def put(a, dt=dtype):
            return torch.as_tensor(a[lo:hi]).to(device=dev, dtype=dt)

        problem = ba_lib.BAProblem(put(wb.poses), put(wb.points), put(wb.obs_cam, torch.int64),
                                   put(wb.obs_lm, torch.int64), put(wb.obs_uv),
                                   put(wb.obs_valid, torch.bool), n_fixed_cams=1)
        poses, points, _ = ba_lib.optimize(problem, iterations, cg_iters, damping)
        out_poses.append(poses)
        out_points.append(points)
    root = out_poses[0].device
    return (torch.cat([p.to(root) for p in out_poses]),
            torch.cat([p.to(root) for p in out_points]))


def stitch_windows(refined_poses: np.ndarray, cam_global: np.ndarray, n_cams: int) -> np.ndarray:
    """Compose window-local refinements into one trajectory.  Window 0 sets
    the frame; each later window is aligned to the running estimate at its
    first camera already placed (a rigid anchor), then its cameras overwrite
    the running estimate: later windows win on overlaps."""
    refined_poses = np.asarray(refined_poses)
    out = [None] * n_cams
    for w in range(refined_poses.shape[0]):
        cams = cam_global[w]
        local = refined_poses[w]
        anchor_global = None
        for i, c in enumerate(cams):
            if out[c] is not None:
                anchor_global = out[c] @ np.linalg.inv(local[i])
                break
        if anchor_global is None:
            anchor_global = np.eye(4)
        for i, c in enumerate(cams):
            out[c] = anchor_global @ local[i]
    return np.stack(out)


def refine_trajectory_windowed(poses: np.ndarray, points: np.ndarray, obs_cam: np.ndarray,
                               obs_lm: np.ndarray, obs_uv: np.ndarray, window: int = 5,
                               stride: int = 3, iterations: int = 6,
                               mesh: Optional[meshlib.Mesh] = None, *, device="cuda",
                               dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Build the windows, refine them together, stitch them: (F, 4, 4)
    world -> camera poses on the host."""
    wb = build_windows(poses, points, obs_cam, obs_lm, obs_uv, window, stride)
    new_poses, _ = refine_windows(wb, iterations, mesh=mesh, device=device, dtype=dtype)
    return stitch_windows(new_poses.cpu().numpy(), wb.cam_global, poses.shape[0])
