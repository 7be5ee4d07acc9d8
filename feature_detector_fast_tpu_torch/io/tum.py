"""TUM RGB-D dataset format support.

Counterpart of ``feature_detector_fast_tpu.io.tum`` (numpy).  Parses the
TUM benchmark layout:
  * `rgb.txt` — "timestamp filename" association lists (with # comments),
  * `groundtruth.txt` — "timestamp tx ty tz qx qy qz qw" trajectories,
and associates them by nearest timestamp, the same policy as the TUM
`associate.py` tool.  Quaternions are converted to the framework's
(4, 4) world_T_cam matrices.

No dataset ships with this repo; these loaders let real sequences plug
straight into `models.slam.run_vo_images`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def read_file_list(path: str) -> List[Tuple[float, List[str]]]:
    """Parse a TUM association file: lines of "timestamp data...", '#'
    comments ignored."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1:]))
    return out


def associate(
    a: List[Tuple[float, List[str]]],
    b: List[Tuple[float, List[str]]],
    max_difference: float = 0.02,
) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (TUM associate.py policy)."""
    pairs = [
        (abs(ta - tb), i, j)
        for i, (ta, _) in enumerate(a)
        for j, (tb, _) in enumerate(b)
        if abs(ta - tb) < max_difference
    ]
    pairs.sort()
    used_a, used_b, out = set(), set(), []
    for _, i, j in pairs:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            out.append((i, j))
    out.sort()
    return out


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) -> (3, 3) rotation matrix."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def groundtruth_poses(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load groundtruth.txt -> (timestamps (N,), world_T_cam (N, 4, 4))."""
    rows = read_file_list(path)
    ts = np.array([t for t, _ in rows])
    poses = []
    for _, vals in rows:
        tx, ty, tz, qx, qy, qz, qw = map(float, vals[:7])
        T = np.eye(4)
        T[:3, :3] = quaternion_to_matrix(np.array([qx, qy, qz, qw]))
        T[:3, 3] = [tx, ty, tz]
        poses.append(T)
    return ts, np.stack(poses)


def load_sequence(
    root: str, max_frames: Optional[int] = None
) -> Tuple[List[str], np.ndarray]:
    """Load a TUM sequence directory: returns (rgb image paths,
    associated ground-truth world_T_cam poses)."""
    rgb = read_file_list(os.path.join(root, "rgb.txt"))
    ts_gt, poses = groundtruth_poses(os.path.join(root, "groundtruth.txt"))
    gt_list = [(t, []) for t in ts_gt]
    assoc = associate(rgb, gt_list)
    if max_frames:
        assoc = assoc[:max_frames]
    paths = [os.path.join(root, rgb[i][1][0]) for i, _ in assoc]
    sel = np.stack([poses[j] for _, j in assoc])
    return paths, sel
