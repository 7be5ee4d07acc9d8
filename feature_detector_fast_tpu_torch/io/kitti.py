"""KITTI odometry dataset format support.

Counterpart of ``feature_detector_fast_tpu.io.kitti`` (numpy; ``Camera``
from the port's ``models.twoview``).  Parses the KITTI odometry benchmark
layout:
  * `sequences/NN/image_0/######.png` — left grayscale frames,
  * `sequences/NN/calib.txt` — "P0: <12 floats>" projection matrices,
  * `poses/NN.txt` — 12 floats per line, the 3x4 world_T_cam of camera 0.

No dataset ships with this repo; these loaders let real sequences plug
straight into ``models.slam.run_vo_images`` (``read_calib`` gives the
VOConfig camera).  Companion of the TUM loader (io/tum.py).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..models import twoview


def read_poses(path: str) -> np.ndarray:
    """Load a KITTI poses file -> (N, 4, 4) world_T_cam matrices."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = rows.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :] = rows
    return poses


def read_calib(path: str, camera_id: int = 0) -> twoview.Camera:
    """Parse calib.txt's "P<id>:" projection into pinhole intrinsics."""
    key = f"P{camera_id}:"
    with open(path) as f:
        for line in f:
            if line.startswith(key):
                p = np.array(line[len(key):].split(),
                             dtype=float).reshape(3, 4)
                return twoview.Camera(
                    float(p[0, 0]), float(p[1, 1]),
                    float(p[0, 2]), float(p[1, 2]),
                )
    raise ValueError(f"no '{key}' entry in {path}")


def load_sequence(
    seq_dir: str,
    poses_path: Optional[str] = None,
    max_frames: Optional[int] = None,
    camera_id: int = 0,
) -> Tuple[List[str], Optional[np.ndarray], twoview.Camera]:
    """Load a KITTI odometry sequence directory.

    Returns (image paths, world_T_cam poses or None, Camera).  If
    ``poses_path`` is not given it is inferred from the standard layout
    (../../poses/<seq>.txt relative to ``seq_dir``); ground truth is
    optional — the eval sequences 11-21 ship without poses.
    """
    img_dir = os.path.join(seq_dir, f"image_{camera_id}")
    names = sorted(
        n for n in os.listdir(img_dir) if n.endswith((".png", ".jpg"))
    )
    if max_frames:
        names = names[:max_frames]
    paths = [os.path.join(img_dir, n) for n in names]

    cam = read_calib(os.path.join(seq_dir, "calib.txt"), camera_id)

    if poses_path is None:
        seq = os.path.basename(os.path.normpath(seq_dir))
        guess = os.path.join(seq_dir, "..", "..", "poses", f"{seq}.txt")
        poses_path = guess if os.path.exists(guess) else None
    poses = None
    if poses_path is not None:
        poses = read_poses(poses_path)
        if max_frames:
            poses = poses[: len(paths)]
    return paths, poses, cam
