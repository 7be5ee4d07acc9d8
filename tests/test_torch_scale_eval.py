"""The scale evaluation and the two stage profiles on the CPU at tiny sizes:
their records, the revisit recall, and the mesh against one device.

``exp_r5_f256_mesh.run`` on 16 frames of a two-lap 320 x 240 circuit at
K=128 over ``[cpu] * 2``; ``exp_vo_stages.run`` on 8 frames at 160 x 120;
``exp_frontend_stages.run`` on a 128 x 256 crop of the 1080p frame.  Times
from these runs are host times of the plain PyTorch versions: only the
records' shape and the counted quantities are checked.
"""

import numpy as np
import pytest
import torch

from feature_detector_fast_tpu_torch.tools import (
    _common, exp_frontend_stages, exp_r5_f256_mesh, exp_vo_stages, vo_bench)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def circuit():
    return vo_bench.sequence(16, 320, 240, workers=1, laps=2)


@pytest.fixture(scope="module")
def mesh_records(circuit):
    return list(exp_r5_f256_mesh.run(16, laps=2, protocol="f256", mesh_devices=[CPU] * 2,
                                     device="cpu", seq=circuit, max_keypoints=128))


def test_revisit_recall_on_hand_built_loops():
    """16 frames, 2 laps: starts 0 and 4, revisits 8 and 12 (within 4)."""
    recall = exp_r5_f256_mesh.revisit_recall
    assert recall([], 16, 2) == 0.0
    assert recall([(0, 8)], 16, 2) == 0.5
    assert recall([(0, 12), (4, 16)], 16, 2) == 1.0  # 12 - 0 - 8 = 4: still a revisit
    assert recall([(0, 13), (4, 3), (1, 9)], 16, 2) == 0.0  # 13 is 5 off; 1 is no start
    loops = [(i, i + 64, None) for i in range(0, 192, 4)]  # extra tuple fields are ignored
    assert recall(loops, 256, 4) == 1.0
    assert recall(loops[: len(loops) // 2], 256, 4) == 0.5


def test_staged_gates_by_protocol_and_mesh():
    """Each protocol's gates, with and without a mesh: the mesh adds its
    tolerance gate, and under f256 the BA gate reads the mesh's BA."""
    ates = {"odometry": 3.0, "loops": 1.5, "ba": 1.4}
    gates = exp_r5_f256_mesh.staged_gates
    assert gates("staged128", ates, 0.0) == {"a1 < 0.6 a0": True, "a2 < a1": True}
    assert gates("f256", ates, 0.8) == {"recall >= 0.8": True, "a1 < 0.7 a0": True,
                                        "a2(one) <= 1.05 a1": True}
    assert gates("f256", ates, 0.7)["recall >= 0.8"] is False
    mesh = dict(ates, ba_mesh=1.6)  # 1.6 > 1.05 * 1.5; |1.6 - 1.4| < 0.3 * 1.6
    assert gates("staged128", mesh, 0.0) == {"a1 < 0.6 a0": True, "a2 < a1": True,
                                             "|a2(mesh) - a2(one)| < 0.3 max": True}
    assert gates("f256", mesh, 1.0) == {"recall >= 0.8": True, "a1 < 0.7 a0": True,
                                        "a2(mesh) <= 1.05 a1": False,
                                        "|a2(mesh) - a2(one)| < 0.3 max": True}
    assert gates("f256", dict(ates, ba_mesh=2.1), 1.0)["|a2(mesh) - a2(one)| < 0.3 max"] is False
    assert gates("staged128", dict(ates, loops=1.9, ba=2.0), 0.0) == {"a1 < 0.6 a0": False,
                                                                      "a2 < a1": False}


def test_scale_evaluation_rejects_an_unknown_protocol(circuit):
    with pytest.raises(ValueError, match="protocol 'f128' is not one of"):
        next(exp_r5_f256_mesh.run(16, laps=2, protocol="f128", device="cpu", seq=circuit))


def test_mesh_evaluation_records(mesh_records):
    """The loop record (with recall), odometry, loops, BA on the mesh and on
    one device, dispatch (null on the CPU), then the summary: four gates, the
    mesh within the tool's 0.3 of one device, the JAX bound beside both BA
    stages."""
    stages = [r["stage"] for r in mesh_records]
    assert stages == ["matches + loop proposal", "odometry", "loops", "ba_mesh", "ba",
                      "dispatch", "f256_f16_mesh"]
    loop_rec = mesh_records[0]
    assert loop_rec["propose"] == {"gap": 10, "top_k": 8, "min_matches": 120}
    assert 0.0 <= loop_rec["revisit_recall"] <= 1.0
    for r in mesh_records[1:5]:
        assert r["sec"] > 0 and np.isfinite(r["ate_pct"])
        assert r["stage_peak_bytes"] is None and r["process_peak_bytes"] is None
        assert r["device"] == "cpu"
    assert mesh_records[3]["mesh"].startswith("Mesh({'data': 2")
    disp = mesh_records[5]
    assert disp["refine_with_ba"]["kernels"] is None and disp["pose_graph_poses"] == 16
    assert disp["pose_graph_edges"] >= 15
    summary = mesh_records[-1]
    assert list(summary["gates"]) == ["recall >= 0.8", "a1 < 0.7 a0", "a2(mesh) <= 1.05 a1",
                                      "|a2(mesh) - a2(one)| < 0.3 max"]
    a = summary["ate_pct"]
    assert set(a) == {"odometry", "loops", "ba_mesh", "ba"}
    assert abs(a["ba_mesh"] - a["ba"]) < exp_r5_f256_mesh.MESH_TOL * max(a["ba_mesh"], a["ba"])
    assert summary["gates"]["|a2(mesh) - a2(one)| < 0.3 max"]
    assert summary["under_jax_bound"] == {k: a[k] < 1.5 for k in ("ba_mesh", "ba")}
    assert summary["protocol"] == "f256"
    assert summary["ok"] == all(summary["gates"].values())


def test_one_device_evaluation_records(circuit):
    """The staged128 protocol with no mesh: no mesh stage, its two gates, its
    proposal (automatic top_k and min_matches); the recall still recorded."""
    recs = list(exp_r5_f256_mesh.run(16, laps=2, protocol="staged128", device="cpu",
                                     seq=circuit, max_keypoints=128))
    assert [r["stage"] for r in recs] == ["matches + loop proposal", "odometry", "loops", "ba",
                                          "dispatch", "staged128_f16"]
    assert recs[0]["propose"] == {"gap": 10} and 0.0 <= recs[0]["revisit_recall"] <= 1.0
    assert list(recs[-1]["gates"]) == ["a1 < 0.6 a0", "a2 < a1"]
    assert set(recs[-1]["under_jax_bound"]) == {"ba"}


def test_scale_evaluation_rejects_another_circuit(circuit):
    """A sequence whose poses are not the asked circuit's raises."""
    with pytest.raises(ValueError, match="not the 16-frame circuit of 4 laps"):
        next(exp_r5_f256_mesh.run(16, laps=4, device="cpu", seq=circuit, max_keypoints=128))


def test_vo_stages_records():
    """Four budgets timed, four odometry ATEs, then run_vo_matches."""
    seq = vo_bench.sequence(8, 160, 120, workers=1)
    recs = list(exp_vo_stages.run(8, device="cpu", reps=1, max_keypoints=64, seq=seq))
    labels = [v[0] for v in exp_vo_stages.VARIANTS]
    assert [r["stage"] for r in recs] == ([f"estimate_pairs {v}" for v in labels]
                                          + [f"odometry_ate {v}" for v in labels]
                                          + ["run_vo_matches (default)"])
    for r in recs[:4] + recs[-1:]:
        assert r["pairs"] == 7 and r["sec"] > 0 and r["min"] <= r["sec"]
        assert r["dispatch"] == dict.fromkeys(("kernels", "copies", "launch_calls", "syncs",
                                               "device_ms", "wall_ms"))
    assert all(np.isfinite(r["ate_pct"]) for r in recs[4:8])


def test_frontend_stages_records():
    """Nested prefixes: each delta is its time less its prefix's."""
    frame = _common.build_1080p_frame()[400:528, 800:1056].copy()
    recs = list(exp_frontend_stages.run(64, device="cpu", batch=2, dense_k=200, rounds=1,
                                        repeats=1, frame=frame))
    assert [r["stage"] for r in recs] == ["detect", "+topk", "+extract", "+plain", "+oriented",
                                          "+topk (k=200)", "+dense (k=200)", "+plain (k=200)"]
    ms = {r["stage"]: r["ms_per_frame"] for r in recs}
    for r in recs:
        assert r["shape"] == [2, 128, 256] and r["ms_per_frame"] > 0
        want = ms[r["stage"]] - (ms[r["prefix"]] if r["prefix"] else 0.0)
        assert r["delta_ms"] == pytest.approx(want)
    assert [r["k"] for r in recs] == [64] * 5 + [200] * 3


def test_staged_stages_match_jax_on_its_draws(x64, monkeypatch, circuit):
    """The evaluation's three stages (odometry, + loops, + BA of the loop
    graph, as ``exp_r5_f256_mesh`` runs them) on the rendered circuit
    against the JAX package's ``run_vo_matches``, float64, on the same
    correspondences, loop pairs (``propose_loop_closures(gap=4)`` at the
    median match count) and RANSAC draws (the JAX package's, injected): the
    same loops accepted and the same SE(3) loop edges, every pair's and
    loop's inliers within 1, each stage's ATE within 15% of the JAX
    package's.  Not poses within 1e-6 as on tests/test_torch_slam.py's clean
    synthetic pairs: this circuit turns 45 degrees a frame, some pairs hold
    22 matches and 8 inliers, and the JAX package refits from a float32
    normal matrix (twoview.py:283-284, ROADMAP queue 3's caveat) where the
    port's refit is float64, so those pairs part by up to 0.5 rad."""
    from feature_detector_fast_tpu.models import slam as jslam
    from feature_detector_fast_tpu_torch.models import slam
    from test_torch_slam import jax_draws

    monkeypatch.setattr(slam, "ransac_draws", jax_draws)
    gt, frames = circuit
    kw = dict(max_keypoints=128, camera=vo_bench.render_config(320, 240).camera(),
              loop_ratio_mad_max=0.15, loop_edge_weight=0.3, loop_edge_min_gap=6,
              ransac_hypotheses=64)
    cfg, jcfg = slam.VOConfig(**kw), jslam.VOConfig(**kw)
    feats = slam.frontend_features(frames, cfg, device="cpu")
    pd = slam.frontend_matches(frames, cfg, features=feats, device="cpu")
    every = slam.propose_loop_closures(frames, cfg, gap=4, min_matches=0, features=feats,
                                       device="cpu")
    counts = sorted(int(e[4].sum()) for e in every)
    loops = slam.propose_loop_closures(frames, cfg, gap=4, min_matches=counts[len(counts) // 2],
                                       features=feats, device="cpu")
    it, mets, jmets = {}, [], []
    got = {"odometry": slam.run_vo_matches(pd, cfg, device="cpu", dtype=torch.float64),
           "loops": slam.run_vo_matches(pd, cfg, loop_pairs=loops, metrics=mets, _internals=it,
                                        device="cpu", dtype=torch.float64)}
    got["ba"] = slam.refine_with_ba(it["graph_poses"], it["batch"], it["est"],
                                    loop_links=it["loop_links"] or None,
                                    graph_edges=it["rot_edges"], device="cpu",
                                    dtype=torch.float64)
    want = {"odometry": jslam.run_vo_matches(list(pd), jcfg),
            "loops": jslam.run_vo_matches(list(pd), jcfg, loop_pairs=loops, metrics=jmets),
            "ba": jslam.run_vo_matches(list(pd), jcfg, loop_pairs=loops, ba_refine=True)}
    edges = [m["pair"] for m in mets if m.get("edge_added")]
    assert edges, "no loop edge: the loop stage would be untested"
    assert edges == [m["pair"] for m in jmets if m.get("edge_added")]
    assert ([m["pair"] for m in mets if m.get("loop_closure")]
            == [m["pair"] for m in jmets if m.get("loop_closure")])
    assert [m["pair"] for m in mets] == [m["pair"] for m in jmets]
    assert all(abs(m["inliers"] - jm["inliers"]) <= 1 for m, jm in zip(mets, jmets))
    for stage in ("odometry", "loops", "ba"):
        assert np.isfinite(got[stage]).all()
        ate, ate_jax = slam.evaluate_ate(got[stage], gt), slam.evaluate_ate(want[stage], gt)
        assert abs(ate - ate_jax) < 0.15 * ate_jax, (stage, ate, ate_jax)
