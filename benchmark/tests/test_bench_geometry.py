"""The VO cells' float64 geometry reference against an exact synthetic
scene: the odometry chain and its link gaps."""

import numpy as np

from benchmark.reference import geometry as geo


def _scene(pairs=4, points=200, seed=0, noise=0.0):
    """A camera walking along x and turning about y, seeing points 3-10
    units ahead: (world_T_cam (P + 1, 4, 4), R (P, 3, 3), t (P, 3), pa, pb
    (P, N, 2))."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, points), rng.uniform(-2, 2, points),
                  rng.uniform(3, 10, points)], -1)
    poses = []
    for k in range(pairs + 1):
        T = np.eye(4)
        c, s = np.cos(0.05 * k), np.sin(0.05 * k)
        T[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
        T[:3, 3] = [0.2 * k, 0.0, 0.03 * k]
        poses.append(T)
    poses = np.stack(poses)
    R, t, pa, pb = [], [], [], []
    for k in range(pairs):
        b_T_a = np.linalg.inv(poses[k + 1]) @ poses[k]
        xa = X @ np.linalg.inv(poses[k])[:3, :3].T + np.linalg.inv(poses[k])[:3, 3]
        xb = xa @ b_T_a[:3, :3].T + b_T_a[:3, 3]
        R.append(b_T_a[:3, :3])
        t.append(b_T_a[:3, 3])
        pa.append(xa[:, :2] / xa[:, 2:] + rng.normal(0, noise, (points, 2)))
        pb.append(xb[:, :2] / xb[:, 2:] + rng.normal(0, noise, (points, 2)))
    return poses, np.stack(R), np.stack(t), np.stack(pa), np.stack(pb)


def test_chain_recovers_the_trajectory_up_to_the_first_pairs_scale():
    poses, R, t, pa, pb = _scene(pairs=5)
    n = pa.shape[1]
    # pair k's slot i is point i, and so is frame k+1's slot: idx_b is the identity
    idx = np.tile(np.arange(n), (len(R), 1))
    s0 = np.linalg.norm(t[0])
    chained = geo.chain(R, t / np.linalg.norm(t, axis=1, keepdims=True),
                        np.ones((len(R), n), bool), pa, pb, idx)
    want = np.linalg.inv(poses[0]) @ poses
    want[:, :3, 3] /= s0
    np.testing.assert_allclose(chained, want, atol=1e-9)
    unit = t / np.linalg.norm(t, axis=1, keepdims=True)
    pose, scale = geo.link_gaps(want, R, unit, chained)
    assert pose.max() < 1e-9 and scale.max() < 1e-9
    turned = want.copy()
    turned[3, :3, :3] = geo_turn(0.01) @ turned[3, :3, :3]
    assert geo.link_gaps(turned, R, unit, chained)[0].max() > 1e-2
    # the links of ``want`` chained again with the third one half as long again
    link = np.linalg.inv(want[1:]) @ want[:-1]
    link[2, :3, 3] *= 1.5
    stretched = [want[0]]
    for b_T_a in link:
        stretched.append(stretched[-1] @ np.linalg.inv(b_T_a))
    scale = geo.link_gaps(np.stack(stretched), R, unit, chained)[1]
    np.testing.assert_allclose(scale, [0.0, np.log(1.5), np.log(1.5), 0.0], atol=1e-9)


def geo_turn(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
