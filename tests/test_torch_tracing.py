"""The port's spans and counts (``utils/tracing``).

With no profiler recording a span records nothing and reads no clock.
Under ``torch.profiler.profile`` spans carry names, parents, request ids
and counts, with a stack per thread, on the clock of the profiler's own
events.  The detection and VO paths open their layers' spans; the pose
graph's step counts equal a recount of its own acceptances; ``profile``'s
trace holds the spans.  One test, marked ``cuda``, holds a span around a
kernel against the kernel's device interval, and needs no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py -q
"""

import glob
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from feature_detector_fast_tpu_torch import api
from feature_detector_fast_tpu_torch.config import Config
from feature_detector_fast_tpu_torch.models import ba, lie, posegraph, slam
from feature_detector_fast_tpu_torch.utils import tracing

JOIN_S = 60.0


@pytest.fixture(autouse=True)
def _empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock with no profiler on")

    monkeypatch.setattr(time, "time_ns", no_clock)
    with tracing.span("outer") as s:
        s.add("n", 3)
        with tracing.span("inner") as t:
            pass
    assert not s and not t and s is t  # the one shared handle
    batch = np.zeros((2, 24, 40), np.uint8)
    assert len(api.detect_batch_arrays(batch, Config(), device="cpu")) == 2
    with slam._staged(None, "pose_graph") as stage:
        assert not stage
    assert tracing.spans() == [] and tracing.spans().dropped == 0


def test_on_records_names_parents_requests_and_counts():
    with cpu_profile():
        with tracing.span("a") as a:
            a.add("n")
            a.add("n", 2)
            with tracing.span("a.b") as b:
                assert b
                with tracing.span("a.b.c"):
                    pass
        with tracing.span("d"):
            pass
    rec = by_name(tracing.spans())
    [a], [b], [c], [d] = rec["a"], rec["a.b"], rec["a.b.c"], rec["d"]
    assert [r.name for r in tracing.spans()] == ["a.b.c", "a.b", "a", "d"]  # order of ending
    assert a.parent == -1 and b.parent == a.id and c.parent == b.id and d.parent == -1
    assert a.request == b.request == c.request == a.id and d.request == d.id != a.id
    assert a.counts == {"n": 3} and b.counts == {} == d.counts
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= a.end_ns
    assert a.end_ns <= d.start_ns
    assert len({r.thread for r in (a, b, c, d)}) == 1


def test_stacks_are_per_thread():
    """Four threads interleave their spans under one profiler: each inner
    span's parent and request are its own thread's outer span."""
    n = 4
    barrier = threading.Barrier(n, timeout=JOIN_S)
    errors = []

    def work(i):
        try:
            with tracing.span(f"outer{i}") as s:
                barrier.wait()  # every outer span open at once
                with tracing.span(f"inner{i}"):
                    barrier.wait()
                s.add("thread", i)
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    with cpu_profile():
        threads = [threading.Thread(target=work, args=(i,), daemon=True) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    rec = by_name(tracing.spans())
    assert len(rec) == 2 * n
    for i in range(n):
        [outer], [inner] = rec[f"outer{i}"], rec[f"inner{i}"]
        assert inner.parent == outer.id and inner.request == outer.id == outer.request
        assert outer.parent == -1 and outer.counts == {"thread": i}
        assert inner.thread == outer.thread
    assert len({rec[f"outer{i}"][0].thread for i in range(n)}) == n


def test_span_shares_the_profilers_clock():
    """A ``record_function`` opened inside a span lies inside it in the same
    profile's events, and the span itself is no profiler event."""
    with cpu_profile() as prof:
        for _ in range(3):
            with tracing.span("stage"):
                time.sleep(0.001)  # room for the two clocks' rounding
                with record_function("inside"):
                    torch.ones(64).sum()
                time.sleep(0.001)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    inside = sorted(e for e in events if e[0] == "inside")
    stages = sorted(tracing.spans(), key=lambda r: r.start_ns)
    assert len(inside) == len(stages) == 3
    for (_, s, e), r in zip(inside, stages):
        assert r.start_ns <= s <= e <= r.end_ns
    assert not any(name == "stage" for name, _, _ in events)


def test_buffer_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 3)
    with cpu_profile():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    got = tracing.spans()
    assert [r.name for r in got] == ["s0", "s1", "s2"] and got.dropped == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.spans().dropped == 0


def test_detection_spans():
    """``detect_batch_arrays`` opens the detection layers' spans, nested as
    the calls are: the copy and the launch inside the batch, then decode and
    split."""
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, (2, 24, 40), np.uint8)
    want = api.detect_batch_arrays(batch, Config(), device="cpu")
    with cpu_profile() as prof:
        got = api.detect_batch_arrays(batch, Config(), device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rec = by_name(tracing.spans())
    [top] = rec["detect.batch"]
    assert {n for n in rec} == {"detect.batch", "detect.h2d", "detect.launch", "detect.decode",
                                "detect.split"}
    for name in ("detect.h2d", "detect.launch", "detect.decode", "detect.split"):
        [r] = rec[name]
        assert r.parent == top.id and r.request == top.id
    order = [rec[n][0].start_ns for n in ("detect.h2d", "detect.launch", "detect.decode",
                                          "detect.split")]
    assert order == sorted(order)
    # No program span reaches the profiler's events (its device timeline).
    assert not any(e.name().startswith("detect.") for e in prof.profiler.kineto_results.events())


def _projections(n_frames=5, n_pts=200, seed=0, noise=0.0):
    """(normalized points, visible) of each frame of a short synthetic
    trajectory, each point moved by Gaussian ``noise``; slot i is landmark
    i."""
    rng = np.random.default_rng(seed)
    lm = np.stack([rng.uniform(-6, 10, n_pts), rng.uniform(-4, 4, n_pts),
                   rng.uniform(4, 22, n_pts)], -1)
    poses = [np.eye(4)]
    for k in range(n_frames - 1):
        step = lie.se3_exp(torch.tensor([0.03 * np.sin(k), 0.0, 0.4, 0.0, 0.06, 0.0],
                                        dtype=torch.float64)).numpy()
        poses.append(poses[-1] @ step)
    projs = []
    for T in poses:
        Xc = (np.linalg.inv(T) @ np.concatenate([lm, np.ones((n_pts, 1))], 1).T).T[:, :3]
        p = Xc[:, :2] / np.maximum(Xc[:, 2:3], 1e-9)
        projs.append((p + rng.normal(0.0, noise, p.shape) if noise else p,
                      (Xc[:, 2] > 0.5) & (np.abs(p) < 0.7).all(1)))
    return projs


def _pairs(n_frames=5, n_pts=200, seed=0):
    """Normalized correspondences of consecutive frames of ``_projections``."""
    projs = _projections(n_frames, n_pts, seed)
    return [(projs[k][0], projs[k + 1][0], projs[k][1] & projs[k + 1][1])
            for k in range(n_frames - 1)]


def test_vo_stages_are_spans_and_still_fill_stage_times():
    """``run_vo_matches``' stages are ``vo.<stage>`` spans, the chain between
    them ``vo.chain``; ``stage_times`` is filled as before, with or without
    a profiler, and each stage's span encloses the seconds it added."""
    cfg = slam.VOConfig(ransac_hypotheses=32)
    pd = _pairs()
    untraced = {}
    want = slam.run_vo_matches(pd, cfg, stage_times=untraced, device="cpu")
    assert set(untraced) == {"odom_estimate_pairs", "pose_graph"}
    times = {}
    with cpu_profile():
        got = slam.run_vo_matches(pd, cfg, stage_times=times, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert set(times) == set(untraced)
    rec = by_name(tracing.spans())
    assert set(rec) == {"vo.odom_estimate_pairs", "vo.chain", "vo.pose_graph"}
    for name, s in times.items():
        [r] = rec[f"vo.{name}"]
        dur = (r.end_ns - r.start_ns) / 1e9
        assert s - 1e-4 <= dur <= s + 0.01, (name, s, dur)
    [pg] = rec["vo.pose_graph"]
    assert pg.counts["steps"] == cfg.pose_graph_iters
    assert 0 <= pg.counts["steps_accepted"] <= cfg.pose_graph_iters
    starts = [rec[n][0].start_ns for n in ("vo.odom_estimate_pairs", "vo.chain",
                                           "vo.pose_graph")]
    assert starts == sorted(starts)


def test_loop_propose_and_ba_solve_counts(monkeypatch):
    """``propose_loop_closures`` is the span ``vo.loop_propose``.  With a
    loop closed, each ``vo.ba_solve`` of the Huber route counts one solve,
    its LM and CG steps, and ``lm_accepted`` equal to a recount from
    ``ba.optimize``'s returned costs (a step counts where it lowered the
    cost, the first against the problem's cost at the start) and to the
    steps after which the poses changed (a rejected step keeps them bit for
    bit); off, nothing is counted and the result is the same."""
    rng = np.random.default_rng(5)
    feats = (torch.from_numpy(rng.integers(0, 64, (12, 32, 2), dtype=np.int32)),
             torch.from_numpy(rng.integers(-2**31, 2**31, (12, 32, 8), dtype=np.int32)),
             torch.ones(12, 32, dtype=torch.bool))
    with cpu_profile():
        slam.propose_loop_closures([None] * 12, slam.VOConfig(), gap=4, features=feats,
                                   device="cpu")
    assert set(by_name(tracing.spans())) == {"vo.loop_propose"}
    tracing.clear()

    n = 5
    projs = _projections(n, noise=2e-3)
    pd = [(projs[k][0], projs[k + 1][0], projs[k][1] & projs[k + 1][1]) for k in range(n - 1)]
    seen = projs[0][1] & projs[n - 1][1]
    loop = (0, n - 1, projs[0][0], projs[n - 1][0], seen,
            np.where(seen, np.arange(len(seen)), -1).astype(np.int32))
    cfg = slam.VOConfig(ransac_hypotheses=32)
    calls = []
    real = ba.optimize

    def keep(p, *a, **k):
        out = real(p, *a, **k)
        calls.append((p, a, out))
        return out

    monkeypatch.setattr(ba, "optimize", keep)
    want = slam.run_vo_matches(pd, cfg, loop_pairs=[loop], ba_refine=True, device="cpu")
    calls.clear()
    with cpu_profile():
        got = slam.run_vo_matches(pd, cfg, loop_pairs=[loop], ba_refine=True, device="cpu")
    np.testing.assert_array_equal(got, want)
    solves = [(p, a, out) for p, a, out in calls if p.poses.dim() == 3]
    records = by_name(tracing.spans())["vo.ba_solve"]
    assert len(records) == len(solves) == 2
    for r, (p, (iters, cg, damping, delta), (_, _, costs)) in zip(records, solves):
        prev, recount = float(ba.total_cost(p, delta)), 0
        for c in costs.tolist():
            recount += c < prev
            prev = c
        assert r.counts == {"solves": 1, "lm_steps": iters, "cg_steps": iters * cg,
                            "lm_accepted": recount}
        assert 0 < recount <= iters
    p, (iters, cg, damping, delta), _ = solves[0]
    before, changed = p.poses, 0
    for k in range(1, iters + 1):
        after = real(p, k, cg, damping, delta)[0]
        changed += not torch.equal(after, before)
        before = after
    assert changed == records[0].counts["lm_accepted"]


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_pose_graph_counts_equal_a_recount(noise):
    """The accepted-step count equals a recount from ``optimize``'s own
    acceptance: run k iterations for k = 1..N, and step k was accepted
    where the poses changed (a rejected step keeps them bit for bit).  A
    chain that starts at its optimum rejects nearly every step; a perturbed
    one accepts some."""
    rng = np.random.default_rng(3)
    n = 6
    step = lie.se3_exp(torch.tensor([[0.1, 0.0, 0.5, 0.0, 0.1, 0.0]], dtype=torch.float64))[0]
    poses = [torch.eye(4, dtype=torch.float64)]
    for _ in range(n - 1):
        poses.append(poses[-1] @ step)
    poses = torch.stack(poses)
    if noise:
        poses = lie.se3_exp(torch.from_numpy(rng.normal(0, noise, (n, 6)))) @ poses
    ei, ej = torch.arange(n - 1), torch.arange(1, n)
    g = posegraph.PoseGraph(poses, ei, ej, step.expand(n - 1, 4, 4).clone(),
                            torch.ones(n - 1, dtype=torch.bool),
                            torch.ones(n - 1, dtype=torch.float64))
    iters = 8
    with cpu_profile():
        with tracing.span("pose_graph") as s:
            counted, _ = posegraph.optimize(g, iters, counts=s)
    [r] = tracing.spans()
    prev, recount = g.poses, 0
    for k in range(1, iters + 1):
        pk, _ = posegraph.optimize(g, k)
        recount += int(not torch.equal(pk, prev))
        prev = pk
    assert torch.equal(prev, counted)
    # One call on the CPU: counted, and never a graph's replay.
    assert r.counts == {"calls": 1, "steps": iters, "steps_accepted": recount,
                        "edges": n - 1, "edge_slots": n - 1}
    assert recount < iters and (recount > 0 or not noise)


def test_pose_graph_counts_nothing_while_off():
    """Off, the handle is false and ``optimize`` neither counts nor changes
    its result."""
    g = posegraph.PoseGraph(torch.eye(4, dtype=torch.float64).expand(3, 4, 4).clone(),
                            torch.tensor([0, 1]), torch.tensor([1, 2]),
                            torch.eye(4, dtype=torch.float64).expand(2, 4, 4).clone(),
                            torch.ones(2, dtype=torch.bool), torch.ones(2, dtype=torch.float64))
    with tracing.span("pose_graph") as s:
        off, _ = posegraph.optimize(g, 3, counts=s)
    assert torch.equal(off, posegraph.optimize(g, 3)[0]) and tracing.spans() == []


def test_profile_trace_holds_the_spans(tmp_path):
    """``profile``'s Chrome trace holds the block's spans as complete events
    on their own track, with their ids, parents and counts, on the time base
    of the profiler's events; ``spans()`` holds them after the block."""
    with tracing.span("before"):
        pass
    with tracing.profile(str(tmp_path), device="cpu"):
        with tracing.span("outer") as s:
            s.add("items", 4)
            time.sleep(0.001)  # room for the two clocks' rounding
            with record_function("inside"):
                time.sleep(0.001)
                with tracing.span("inner"):
                    torch.ones(64).sum()
                time.sleep(0.001)
            time.sleep(0.001)
    [path] = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat") == "fdf_span"}
    assert set(ours) == {"outer", "inner"}
    outer, inner = ours["outer"], ours["inner"]
    assert outer["ph"] == inner["ph"] == "X" and outer["pid"] == inner["pid"]
    assert inner["args"]["parent"] == outer["args"]["id"] and outer["args"]["items"] == 4
    [rf] = [e for e in events if e.get("name") == "inside" and e.get("cat") != "fdf_span"]
    assert outer["ts"] <= rf["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= rf["ts"] + rf["dur"] <= outer["ts"] + outer["dur"]
    assert [r.name for r in tracing.spans()] == ["inner", "outer"]


def test_span_cost_tool_record():
    from feature_detector_fast_tpu_torch.tools import span_cost

    rec = span_cost.run(rounds=1, spans=200)
    assert {"span_off_ns", "span_on_ns", "record_function_off_ns",
            "record_function_on_ns"} <= set(rec)
    assert all(rec[k] > 0 for k in rec if k.endswith("_ns"))
    assert tracing.spans() == []  # the tool leaves the buffer empty


@pytest.mark.cuda
def test_span_encloses_its_kernel_on_the_card():
    """On the card: a span around one kernel launch and a synchronize holds
    that kernel's device interval, and the span adds nothing to the device
    events the benchmark's trace reader keeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from benchmark.yardstick import trace as trace_lib

    x = torch.ones(1 << 22, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracing.span("one_kernel"):
            time.sleep(0.001)  # room for the host's and the device's clocks
            x.mul_(2.0)
            torch.cuda.synchronize()
            time.sleep(0.001)
    [r] = tracing.spans()
    t = trace_lib.collect(prof, 1, 1, (r.end_ns - r.start_ns) / 1e9)
    assert [t.kind(n) for n, _, _ in t.device] == ["kernel"], t.device
    [(_, s, e)] = t.device
    assert r.start_ns <= s <= e <= r.end_ns
    assert not any("one_kernel" in n for n, _, _ in t.device)
