"""Real-texture warp sequences with exact ground truth.

Counterpart of ``feature_detector_fast_tpu.io.warp`` (numpy; ``Camera``
from the port's ``models.twoview``).  The rendered scenes (io.render) give
exact poses but synthetic checker textures, and no real camera sequence
ships with the repo.  The achievable substitute: treat a REAL image (the
reference repo's screenshot, media/Screenshot315_torch_grey.png, or the
committed golden_1080p frame) as the texture of a 3-D plane and move a
camera over it.  Every frame is then an exact plane-induced homography of the
source image —

    H_k  ~  K (R_k - t_k n^T / d) K^{-1}

for world->camera extrinsics [R_k | t_k], plane z = d with normal
n = [0, 0, 1] in the frame-0 camera (= world) frame — so front-end
match quality and two-view epipolar consistency can be asserted against
EXACT ground truth on real image statistics, with the render module's
degradation stack (blur/vignette/noise) applied on top.

A planar scene is degenerate for essential-matrix ESTIMATION (that is
what io.render's interior boxes exist for), so these sequences validate
the front-end — detection repeatability, BRIEF matching, epipolar
consistency under the exact E = [t]x R — not pose recovery.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..models import twoview
from .render import RenderConfig, _degrade


def plane_homographies(
    w2c: np.ndarray, cam: twoview.Camera, depth: float
) -> np.ndarray:
    """Pixel-space homographies H (F, 3, 3) mapping frame-0 pixels onto
    frame-k pixels, for the plane z = ``depth`` in the frame-0 camera
    frame.  ``w2c``: (F, 4, 4) world->camera with world = frame-0 camera
    (w2c[0] = I)."""
    K = np.array([[cam.fx, 0.0, cam.cx],
                  [0.0, cam.fy, cam.cy],
                  [0.0, 0.0, 1.0]])
    Kinv = np.linalg.inv(K)
    w2c = np.asarray(w2c, np.float64)
    n = np.array([0.0, 0.0, 1.0])
    Hs = []
    for T in w2c:
        R, t = T[:3, :3], T[:3, 3]
        H = K @ (R - np.outer(t, n) / float(depth)) @ Kinv
        Hs.append(H / H[2, 2])
    return np.stack(Hs)


def warp_image(image: np.ndarray, H: np.ndarray,
               fill: float = 0.0) -> np.ndarray:
    """Inverse-warp ``image`` by pixel-space homography ``H`` (maps
    source pixel -> destination pixel), bilinear, float64 output the
    caller degrades/quantizes.  Out-of-source pixels take ``fill``."""
    h, w = image.shape
    Hinv = np.linalg.inv(np.asarray(H, np.float64))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    q = np.stack([xx, yy, np.ones_like(xx)], axis=-1) @ Hinv.T
    sx = q[..., 0] / q[..., 2]
    sy = q[..., 1] / q[..., 2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = sx - x0
    fy = sy - y0
    valid = (x0 >= 0) & (y0 >= 0) & (x0 < w - 1) & (y0 < h - 1)
    x0c = np.clip(x0, 0, w - 2)
    y0c = np.clip(y0, 0, h - 2)
    img = image.astype(np.float64)
    p00 = img[y0c, x0c]
    p01 = img[y0c, x0c + 1]
    p10 = img[y0c + 1, x0c]
    p11 = img[y0c + 1, x0c + 1]
    out = (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
           + p10 * (1 - fx) * fy + p11 * fx * fy)
    return np.where(valid, out, float(fill))


def plane_trajectory(n_frames: int, depth: float,
                     shift: float = 0.02, yaw: float = 0.004,
                     dolly: float = 0.01) -> np.ndarray:
    """(F, 4, 4) world->camera extrinsics for a gentle sweep over the
    plane: lateral translation + small yaw + slight dolly per frame,
    scaled by ``depth`` so pixel motion is resolution-independent.
    w2c[0] = I (world = frame-0 camera)."""
    out = []
    for k in range(n_frames):
        c, s = np.cos(yaw * k), np.sin(yaw * k)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        T[:3, 3] = [shift * depth * k, 0.4 * shift * depth * np.sin(0.8 * k),
                    dolly * depth * np.sin(0.5 * k)]
        out.append(T)
    return np.stack(out)


def warp_sequence(
    image: np.ndarray, w2c: np.ndarray, cam: twoview.Camera, depth: float,
    degrade: RenderConfig | None = None,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Warp ``image`` through the plane homographies of ``w2c`` and
    optionally run io.render's degradation stack (blur/vignette/noise
    fields of ``degrade``; its geometry fields are ignored).  Returns
    (frames uint8, H (F, 3, 3) exact frame-0 -> frame-k pixel maps)."""
    Hs = plane_homographies(w2c, cam, depth)
    frames = []
    for k, H in enumerate(Hs):
        f = warp_image(image, H)
        if degrade is not None:
            cfg = RenderConfig(
                width=image.shape[1], height=image.shape[0],
                fx=cam.fx, fy=cam.fy, seed=degrade.seed,
                noise_sigma=degrade.noise_sigma, blur=degrade.blur,
                vignette=degrade.vignette,
            )
            f = _degrade(f, cfg, k)
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    return frames, Hs


def project_through(H: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Map (N, 2) pixel coordinates through a homography."""
    q = np.concatenate([xy, np.ones_like(xy[:, :1])], axis=1) @ \
        np.asarray(H, np.float64).T
    return q[:, :2] / q[:, 2:3]


def exact_essential(w2c_k: np.ndarray) -> np.ndarray:
    """E = [t]x R for world->camera [R | t] with world = frame-0 camera:
    the exact epipolar constraint q_k^T E q_0 = 0 every true
    correspondence satisfies (normalized coordinates)."""
    R, t = np.asarray(w2c_k)[:3, :3], np.asarray(w2c_k)[:3, 3]
    tx = np.array([[0.0, -t[2], t[1]],
                   [t[2], 0.0, -t[0]],
                   [-t[1], t[0], 0.0]])
    return tx @ R
