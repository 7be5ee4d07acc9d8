"""The VO cells' frames: a ray-cast textured room seen from a loop circuit,
rendered in PyTorch float64 on the device.

A copy of the port's ``io/render.render_frame`` and ``loop_trajectory`` (a
room of five checker-textured walls with hashed grey levels, interior
boxes, then blur, vignette and hashed noise), frozen here so that a change to
the program cannot change the benchmark's inputs.  One departure: the noise
field is seeded by ``noise_seed`` apart from the scene's ``seed`` (the
original seeds both with ``seed``), so a run's seed changes the noise and not
the room.  Integer hashes wrap in 64 bits as NumPy's do.  Frames agree with
the original's to within one grey level (rounding of the float64 ray
arithmetic); ``benchmark/tests`` holds them to it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

#: The room's fixed extents (world units); the camera starts near the origin
#: looking down +z.
ROOM = dict(x_min=-4.0, x_max=4.0, y_min=-2.5, y_max=2.5, box_z_near=5.0, box_z_far=10.0)


def _wrap64(v: int) -> int:
    return (v + (1 << 63)) % (1 << 64) - (1 << 63)


def _hash2(a: torch.Tensor, b: torch.Tensor, salt: int) -> torch.Tensor:
    """Integer hash of two int64 tensors to [0, 1) float64."""
    h = (a * 73856093) ^ (b * 19349663) ^ _wrap64(int(salt) * 83492791)
    h = h & 0x7FFFFFFF
    h = (h * 2654435761) & 0x7FFFFFFF
    return h.to(torch.float64) / float(0x80000000)


def _hash2_scalar(a: int, b: int, salt: int) -> float:
    h = _wrap64(_wrap64(a * 73856093) ^ _wrap64(b * 19349663) ^ _wrap64(salt * 83492791))
    h &= 0x7FFFFFFF
    h = (h * 2654435761) & 0x7FFFFFFF
    return h / float(0x80000000)


def loop_trajectory(n_frames: int, radius: float = 2.0, sway: float = 0.25,
                    laps: int = 1) -> np.ndarray:
    """(F, 4, 4) float64 world_T_cam of a circuit in the x-z plane with a
    vertical sway and a small yaw wobble: the last frames revisit the first."""
    poses = []
    for k in range(n_frames):
        th = 2.0 * np.pi * int(laps) * k / n_frames
        yaw = 0.12 * np.sin(th)
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T[:3, 3] = [radius * np.sin(th), sway * np.sin(2 * th), radius * (1.0 - np.cos(th))]
        poses.append(T)
    return np.stack(poses)


def _boxes(scene: Dict) -> List[Tuple[np.ndarray, np.ndarray]]:
    r = {**ROOM, **scene}
    out = []
    for b in range(int(scene["n_boxes"])):
        u = [_hash2_scalar(b, i, int(scene["seed"]) * 31 + 7) for i in range(6)]
        cx = r["x_min"] + 1.0 + u[0] * (r["x_max"] - r["x_min"] - 2.0)
        cy = r["y_min"] + 0.8 + u[1] * (r["y_max"] - r["y_min"] - 1.6)
        cz = r["box_z_near"] + u[2] * (r["box_z_far"] - r["box_z_near"])
        sx, sy, sz = 0.4 + 0.8 * u[3], 0.4 + 0.8 * u[4], 0.4 + 0.8 * u[5]
        out.append((np.array([cx - sx / 2, cy - sy / 2, cz - sz / 2]),
                    np.array([cx + sx / 2, cy + sy / 2, cz + sz / 2])))
    return out


def _texture(u, v, wall: int, scene: Dict) -> torch.Tensor:
    cu = torch.floor(u / scene["cell"]).nan_to_num(0.0, 0.0, 0.0).to(torch.int64)
    cv = torch.floor(v / scene["cell"]).nan_to_num(0.0, 0.0, 0.0).to(torch.int64)
    return 30.0 + 195.0 * _hash2(cu, cv, wall * 7919 + int(scene["seed"]) * 104729)


def render_frames(poses: np.ndarray, scene: Dict, first_id: int, noise_seed: int,
                  device) -> torch.Tensor:
    """(F, H, W) u8 frames from (F, 4, 4) world_T_cam ``poses``, frame k
    with the noise of frame ``first_id + k``.  ``scene`` holds width,
    height, fx, fy, z_back, cell, n_boxes, noise_sigma, blur, vignette and
    the room's seed."""
    r = {**ROOM, **scene}
    h, w = int(scene["height"]), int(scene["width"])
    cx, cy = w / 2.0 - 0.5, h / 2.0 - 0.5
    f64 = dict(dtype=torch.float64, device=device)
    xs = (torch.arange(w, **f64) - cx) / scene["fx"]
    ys = (torch.arange(h, **f64) - cy) / scene["fy"]
    dy, dx = torch.meshgrid(ys, xs, indexing="ij")
    d_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1)
    poses = np.asarray(poses)
    n = len(poses)
    R = torch.as_tensor(poses[:, :3, :3], **f64)
    o = torch.as_tensor(poses[:, :3, 3], **f64)[:, None, None, :]  # (F, 1, 1, 3)
    d = d_cam[None] @ R.transpose(1, 2)[:, None]  # (F, H, W, 3)
    best = torch.full((n, h, w), float("inf"), **f64)
    img = torch.zeros((n, h, w), **f64)

    def hit(axis, plane, lo, hi, axes, wall):
        nonlocal img, best
        with torch.no_grad():
            t = (plane - o[..., axis]) / d[..., axis]
            p = o + t[..., None] * d
            ok = (t > 1e-6) & torch.isfinite(t)
            for ax in axes:
                ok &= (p[..., ax] >= lo[ax]) & (p[..., ax] <= hi[ax])
            closer = ok & (t < best)
            tex = _texture(p[..., axes[0]], p[..., axes[1]], wall, scene)
            img = torch.where(closer, tex, img)
            best = torch.where(closer, t, best)

    eps = 1e-9
    lo = [r["x_min"] - eps, r["y_min"] - eps, 0.0 - eps]
    hi = [r["x_max"] + eps, r["y_max"] + eps, scene["z_back"] + eps]
    walls = [(0, r["x_min"]), (0, r["x_max"]), (1, r["y_min"]), (1, r["y_max"]),
             (2, scene["z_back"])]
    for wall, (axis, plane) in enumerate(walls):
        hit(axis, plane, lo, hi, [a for a in range(3) if a != axis], wall)
    for bi, (blo, bhi) in enumerate(_boxes(scene)):
        for fi in range(6):
            axis = fi // 2
            plane = float((blo, bhi)[fi % 2][axis])
            hit(axis, plane, blo - eps, bhi + eps, [a for a in range(3) if a != axis],
                10 + bi * 6 + fi)
    return torch.stack([_degrade(f, scene, first_id + k, noise_seed)
                        for k, f in enumerate(img)])


def _degrade(img: torch.Tensor, scene: Dict, frame_id: int, noise_seed: int) -> torch.Tensor:
    h, w = img.shape
    if scene["blur"]:
        p = torch.cat([img[:1], img, img[-1:]], 0)
        img = p[:-2] * 0.25 + p[1:-1] * 0.5 + p[2:] * 0.25
        p = torch.cat([img[:, :1], img, img[:, -1:]], 1)
        img = p[:, :-2] * 0.25 + p[:, 1:-1] * 0.5 + p[:, 2:] * 0.25
    yy, xx = torch.meshgrid(torch.arange(h, device=img.device),
                            torch.arange(w, device=img.device), indexing="ij")
    if scene["vignette"]:
        cx, cy = w / 2.0 - 0.5, h / 2.0 - 0.5
        xf, yf = xx.to(torch.float64), yy.to(torch.float64)
        r2 = ((xf - cx) / (w / 2.0)) ** 2 + ((yf - cy) / (h / 2.0)) ** 2
        img = img * (1.0 - scene["vignette"] * r2 / 2.0)
    if scene["noise_sigma"]:
        salt = int(noise_seed) * 2654435761 + int(frame_id) * 40503
        u = sum(_hash2(xx, yy, salt + i) for i in range(4))
        img = img + (u - 2.0) * np.sqrt(3.0) * scene["noise_sigma"]
    return torch.clamp(img, 0, 255).to(torch.uint8)


def render_circuit(scene: Dict, frames: int, noise_seed: int, device, chunk: int = 16
                   ) -> Tuple[np.ndarray, torch.Tensor]:
    """(ground-truth (F, 4, 4) poses, (F, H, W) u8 frames on ``device``) of
    one lap of the circuit, rendered ``chunk`` frames at a time."""
    gt = loop_trajectory(frames, radius=float(scene["radius"]))
    imgs = torch.cat([render_frames(gt[k:k + chunk], scene, k, noise_seed, device)
                      for k in range(0, frames, chunk)])
    return gt, imgs
