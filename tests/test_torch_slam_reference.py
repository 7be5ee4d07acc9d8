"""The port's loop and bundle-adjustment stages against the benchmark's plain
float64 references (``benchmark/reference/slam.py``, ``ba.py``), on the CPU
at a small size: 16 frames of a rendered 160 x 120 circuit (radius 0.5, so
that consecutive frames overlap), K = 128, loop proposal at gap 8 and 30
matches, which closes a few loops and runs the Huber route of
``refine_with_ba``.

The references share no code with the port, so agreement in float64 to
rounding says both follow one algorithm; the float32 program is then held
to the reference within what its rounding and its conjugate-gradient
budget leave."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.data import render
from benchmark.reference import ba as ref_ba
from benchmark.reference import brief as ref_brief
from benchmark.reference import se3
from benchmark.reference import slam as ref_slam
from feature_detector_fast_tpu_torch.models import ba, posegraph, slam, twoview

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, WIDTH, HEIGHT, FOCAL, K = 16, 160, 120, 130.0, 128
GAP, TOP_K, MIN_MATCHES, SEED = 8, 8, 30, 7
DELTA, DAMPING, ITERS = 0.01, 1e-4, 20


@pytest.fixture(scope="module")
def sequence():
    """The rendered frames, the port's proposals and a float32 run of loops +
    BA with each global BA round's (problem, result) recorded."""
    with open(os.path.join(REPO, "benchmark", "configs", "vo-tum-vga-slam.json")) as f:
        scene = json.load(f)["scene"]
    scene.update(width=WIDTH, height=HEIGHT, fx=FOCAL, fy=FOCAL, radius=0.5)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    gt, frames = render.render_circuit(scene, FRAMES, SEED, "cpu")
    cfg = slam.VOConfig(max_keypoints=K, seed=SEED,
                        camera=twoview.Camera(FOCAL, FOCAL, WIDTH / 2 - 0.5, HEIGHT / 2 - 0.5))
    host = list(frames.numpy())
    feats = slam.frontend_features(host, cfg, device="cpu")
    pairs = slam.frontend_matches(host, cfg, features=feats, device="cpu")
    loops = slam.propose_loop_closures(host, cfg, gap=GAP, top_k=TOP_K, min_matches=MIN_MATCHES,
                                       features=feats, device="cpu")
    rounds = []
    real = ba.optimize

    def keep(p, *a, **k):
        out = real(p, *a, **k)
        if p.poses.dim() == 3:
            rounds.append((p, out))
        return out

    internals = {}
    ba.optimize = keep
    try:
        poses = slam.run_vo_matches(pairs, cfg, loop_pairs=loops, ba_refine=True,
                                    _internals=internals, device="cpu")
    finally:
        ba.optimize = real
        torch.set_num_threads(n)
    return dict(gt=gt, frames=frames, cfg=cfg, loops=loops, internals=internals, poses=poses,
                rounds=rounds)


def _problem(p):
    return ref_ba.Problem(p.poses, p.points, p.obs_cam, p.obs_lm, p.obs_uv, p.obs_valid)


def _as_port(p: ref_ba.Problem, dtype=torch.float64):
    return ba.BAProblem(p.w2c.to(dtype), p.points.to(dtype), p.obs_cam, p.obs_lm,
                        p.obs_uv.to(dtype), p.valid, n_fixed_cams=1)


def test_the_sequence_closes_loops(sequence):
    """The size is one that exercises the loop path: loop edges in the graph
    and two rounds of Huber BA."""
    g = sequence["internals"]["graph"]
    assert len(g.edge_i) > FRAMES - 1 and len(sequence["rounds"]) == 2


def test_propose_loop_closures_is_exact(sequence):
    """The same candidate pairs kept, and the same matches slot by slot."""
    _, _, desc, dvalid = ref_brief.features(sequence["frames"], 16, 9, K)
    want = ref_slam.propose(desc, dvalid, GAP, TOP_K, MIN_MATCHES)
    got = sequence["loops"]
    assert [(g[0], g[1]) for g in got] == [(w[0], w[1]) for w in want]
    for g, (_, _, idx) in zip(got, want):
        np.testing.assert_array_equal(g[4], (idx >= 0).numpy())
        np.testing.assert_array_equal(g[5][g[4]], idx.numpy()[g[4]])


def test_loop_pose_graph(sequence):
    """The reference's 40 robust LM steps from the graph the program
    assembled: the port's optimizer in float64 agrees to 1e-9 (rounding of
    the finite-difference Jacobian, 1e-12 read); the float32 program within
    1e-4 of a radian and of the path length (float32 rounding over 40
    steps of a 90-unknown dense solve; 1e-6 read)."""
    g = sequence["internals"]["graph"]
    want, costs = ref_slam.pose_graph(*g, 40, 0.25)
    g64 = posegraph.PoseGraph(*(t.double() if t.is_floating_point() else t for t in g))
    got64, costs64 = posegraph.optimize(g64, 40, "dense", robust_delta=0.25)
    path = float(torch.linalg.vector_norm(want[1:, :3, 3] - want[:-1, :3, 3], dim=1).sum())

    def gaps(poses):
        poses = poses.double()
        rot = float(se3.angle(poses[:, :3, :3].transpose(1, 2) @ want[:, :3, :3]).max())
        return rot, float(torch.linalg.vector_norm(poses[:, :3, 3] - want[:, :3, 3], dim=1).max()
                          ) / path

    assert max(gaps(got64)) < 1e-9
    np.testing.assert_allclose(costs64.numpy(), costs, rtol=1e-9)
    assert max(gaps(torch.as_tensor(sequence["internals"]["graph_poses"]))) < 1e-4


@pytest.mark.parametrize("which, edges", [("a", 259), ("b", 309)])
def test_float32_loop_graph_at_the_cells_size(which, edges):
    """Two loop graphs as the program assembled them on the card for the
    SLAM cell (64 VGA frames, float32; ``tests/data/loop_graphs_vga64.npz``),
    where J^T J reaches a condition of ~5.6e10: the float32 pose graph, its
    normal equations formed and solved in float64, follows the reference's
    40 robust steps within 1e-3 of a radian in every link and of the path
    (float32 Jacobians on the weakest modes; 2.4e-6 and 1.1e-4 read).  With
    the normal equations in float32 the same graphs part by 0.0147 and
    0.094 rad in a link."""
    data = np.load(os.path.join(REPO, "tests", "data", "loop_graphs_vga64.npz"))
    g = posegraph.PoseGraph(*(torch.as_tensor(data[f"{which}_{k}"])
                              for k in posegraph.PoseGraph._fields))
    assert g.poses.dtype == torch.float32 and g.edge_i.shape[0] == edges
    want, _ = ref_slam.pose_graph(*g, 40, 0.25)
    got, _ = posegraph.optimize(g, 40, "dense", robust_delta=0.25)
    got = got.double()
    link = se3.angle((got[:-1, :3, :3].transpose(1, 2) @ got[1:, :3, :3]).transpose(1, 2)
                     @ (want[:-1, :3, :3].transpose(1, 2) @ want[1:, :3, :3]))
    path = float(torch.linalg.vector_norm(want[1:, :3, 3] - want[:-1, :3, 3], dim=1).sum())
    centre = torch.linalg.vector_norm(got[:, :3, 3] - want[:, :3, 3], dim=1) / path
    assert float(link.max()) < 1e-3 and float(centre.max()) < 1e-3


def test_huber_cost_equals_the_ports(sequence):
    """The cost both sides' LM steps are accepted on, to float64 rounding."""
    p, (w2c, pts, _) = sequence["rounds"][0]
    for q in (_problem(p).f64(), _problem(p)._replace(w2c=w2c, points=pts).f64()):
        want = float(ba.total_cost(_as_port(q), DELTA))
        assert abs(float(ref_ba.huber_cost(q, DELTA)) - want) <= 1e-12 * want
        plain = float(ba.total_cost(_as_port(q), 0.0))
        assert abs(float(ref_ba.huber_cost(q, 0.0)) - plain) <= 1e-12 * plain


def test_one_ba_round(sequence):
    """The reference's 20 LM steps from the program's first gated problem.
    The port in float64 with CG run to convergence (300 steps for 96
    unknowns) takes the same steps: costs to 1e-8, poses to 1e-6 (they part
    along the scale, a direction only the damping holds: 3.4e-7 read).  The
    float32 program's 40 CG steps stop short of the exact step: its cost
    within 1.2x of the reference's (1.03x read).  With the reference's own
    CG budget, the port's float64 costs agree step for step."""
    p, (w2c, pts, _) = sequence["rounds"][0]
    q = _problem(p).f64()
    ref, costs = ref_ba.solve(q, ITERS, DAMPING, DELTA)
    w64, _, c64 = ba.optimize(_as_port(q), ITERS, 300, DAMPING, DELTA)
    np.testing.assert_allclose(c64.numpy(), costs, rtol=1e-8)
    np.testing.assert_allclose(w64.numpy(), ref.w2c.numpy(), rtol=0, atol=1e-6)
    prog = float(ref_ba.huber_cost(q._replace(w2c=w2c, points=pts).f64(), DELTA))
    assert costs[-1] <= prog < 1.2 * costs[-1]
    # The reference's fixed conjugate-gradient budget is the port's: 8 steps,
    # short of the rounding floor, agree to 1e-8 in float64.
    _, cg_costs = ref_ba.solve(q, ITERS, DAMPING, DELTA, cg_iters=8)
    _, _, c8 = ba.optimize(_as_port(q), ITERS, 8, DAMPING, DELTA)
    np.testing.assert_allclose(c8.numpy(), cg_costs, rtol=1e-8)


def test_rotation_average_triangulate_and_gate(sequence):
    """The program's first problem from the reference's rotation averaging,
    triangulation and gating of the pose graph's result: the port's float32
    averaging within 1e-5 rad of the reference's, and from the port's own
    averaged rotations (``refine_with_ba``'s call, repeated) every validity
    bit as the program made it and every point it uses within 1e-4."""
    it = sequence["internals"]
    p, _ = sequence["rounds"][0]
    ei, ej, eR, ew = it["rot_edges"]
    eR = np.asarray([np.asarray(R)[:3, :3] for R in eR])
    cur = np.array(it["graph_poses"])
    f32 = dict(dtype=torch.float32)
    Rw = posegraph.rotation_average(torch.as_tensor(cur[:, :3, :3], **f32),
                                    torch.as_tensor(ei), torch.as_tensor(ej),
                                    torch.as_tensor(eR, **f32), torch.as_tensor(ew, **f32))
    want = ref_slam.rotation_average(torch.as_tensor(cur[:, :3, :3], **f32), ei, ej, eR, ew)
    assert float(se3.angle(Rw.double().transpose(1, 2) @ want).max()) < 1e-5
    cur[:, :3, :3] = Rw.numpy()
    w2c = torch.as_tensor(np.linalg.inv(cur))
    uv = p.obs_uv.double()
    pts = ref_slam.triangulate(w2c, p.obs_cam, p.obs_lm, uv, p.points.shape[0])
    valid = ref_slam.gate(w2c, pts, p.obs_cam, p.obs_lm, uv)
    assert torch.equal(valid, p.obs_valid)
    used = torch.zeros(p.points.shape[0], dtype=torch.bool)
    used[p.obs_lm[valid]] = True
    np.testing.assert_allclose(pts[used].numpy(), p.points[used].double().numpy(), rtol=1e-4,
                               atol=1e-4)


def test_refine_with_ba_against_the_reference_chain(sequence):
    """``refine_with_ba`` in float64 with CG run to convergence against the
    reference's chain of rounds from the same first problem: the second
    round triangulated and gated from the reference's own first result.
    Camera centres within 1e-6 of the path length."""
    it = sequence["internals"]
    rounds = []
    real = ba.optimize

    def keep(p, *a, **k):
        out = real(p, *a, **k)
        rounds.append(p)
        return out

    ba.optimize = keep
    try:
        got = slam.refine_with_ba(it["graph_poses"], it["batch"], it["est"],
                                  loop_links=it["loop_links"], graph_edges=it["rot_edges"],
                                  loop_cg_iters=300, device="cpu", dtype=torch.float64)
    finally:
        ba.optimize = real
    chain, _ = ref_ba.solve(_problem(rounds[0]), ITERS, DAMPING, DELTA)
    p = _problem(rounds[1])
    pts = ref_slam.triangulate(chain.w2c, p.obs_cam, p.obs_lm, p.obs_uv, p.points.shape[0])
    valid = ref_slam.gate(chain.w2c, pts, p.obs_cam, p.obs_lm, p.obs_uv)
    chain, _ = ref_ba.solve(p._replace(w2c=chain.w2c, points=pts, valid=valid), ITERS, DAMPING,
                            DELTA)
    want = torch.linalg.inv(chain.w2c)
    path = float(torch.linalg.vector_norm(want[1:, :3, 3] - want[:-1, :3, 3], dim=1).sum())
    gap = torch.linalg.vector_norm(torch.as_tensor(got)[:, :3, 3] - want[:, :3, 3], dim=1)
    assert float(gap.max()) / path < 1e-6
