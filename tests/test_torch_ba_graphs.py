"""Global BA padded to capacities, and its CUDA graph: eager on the CPU,
replayed on the card.

A global ``ba.optimize`` call on the card given ``obs_capacity`` /
``lm_capacity`` is padded with rows of exact zeros before its graph key is
taken, so that problems of one camera count share a key; it returns the
unpadded call's shapes and, in float64, its answer to rounding.  Off the
card the call runs unpadded.  The padding and the graph cache's
bookkeeping (a capture at a key's third call in a row, one graph a device,
a cache apart from the pose graph's, the counters on the span) are held on
the CPU with a stand-in graph that runs the padded steps eagerly.  The tests
marked ``cuda`` run the real graphs on a card and skip where there is none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ba_graphs.py -q

There ``scatter_add``'s atomics reorder float64 sums, so a replay equals
the padded eager call to rounding, not bit for bit.  A last test checks
that the detection benchmark's drivers load none of the VO back-end.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from feature_detector_fast_tpu_torch.models import ba, lie, posegraph, slam
from feature_detector_fast_tpu_torch.utils import cuda_graphs, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The SLAM cell's global solve: 20 LM steps of 40 CG steps, damping 1e-4,
#: Huber delta 0.01 (fewer steps here, the same kind of call).
ARGS = (4, 12, 1e-4, 0.01)


class Counts:
    """A ``tracing.span`` handle that always records."""

    def __init__(self):
        self.counts = {}

    def add(self, counter: str, n: int = 1) -> None:
        self.counts[counter] = self.counts.get(counter, 0) + n

    def __bool__(self) -> bool:
        return True

    def read(self, *names):
        return tuple(self.counts.get(n, 0) for n in names)


def problem(seed: int, cams: int = 6, lms: int = 80, dtype=torch.float64, device="cpu"
            ) -> ba.BAProblem:
    """A global problem: ``cams`` cameras on an arc (camera 0 at the
    identity, fixed), ``lms`` landmarks each seen by a random ~70% of them,
    noisy observations, about 1 in 10 invalid, perturbed starts."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((cams, 6))
    xi[:, 0] = -0.4 * np.arange(cams)
    xi[:, 4] = 0.05 * np.sin(np.arange(cams))
    gt = lie.se3_exp(torch.from_numpy(xi)).numpy()
    pts = np.stack([rng.uniform(-1, cams * 0.4 + 1, lms), rng.uniform(-2, 2, lms),
                    rng.uniform(5, 9, lms)], -1)
    seen = rng.random((cams, lms)) < 0.7
    obs_cam, obs_lm = (a.astype(np.int64) for a in np.nonzero(seen))
    Xc = np.einsum("oij,oj->oi", gt[obs_cam, :3, :3], pts[obs_lm]) + gt[obs_cam, :3, 3]
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 2e-3, (len(obs_cam), 2))
    valid = rng.random(len(obs_cam)) > 0.1
    kick = lie.se3_exp(torch.from_numpy(rng.normal(0, 0.03, (cams, 6)))).numpy()
    kick[0] = np.eye(4)
    arrays = (kick @ gt, pts + rng.normal(0, 0.1, pts.shape), obs_cam, obs_lm, uv, valid)
    return ba.BAProblem(*(torch.from_numpy(a).to(device, dtype) if a.dtype == np.float64
                          else torch.from_numpy(a).to(device) for a in arrays), n_fixed_cams=1)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Widest difference over the widest entry."""
    return float((got - want).abs().max() / want.abs().max())


def worst(got, want) -> float:
    """The widest ``rel`` over (poses, points, costs)."""
    return max(rel(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("delta", [0.0, 0.01])
def test_padded_problem_gives_the_unpadded_answer(fake_graphs, delta):
    """Padded by 137 observations and 23 landmarks, a float64 problem's
    poses, points and costs lie within 1e-10 relative of the unpadded
    call's, in its shapes, on the plain and the Huber route: the first two
    calls run eagerly and unpadded, the third and fourth on the padded
    problem (the stand-in graph).  The padded rows are invalid, and the
    padded landmarks come back where they were."""
    p = problem(0)
    args = (6, 20, 1e-4, delta)
    n_obs, n_lm = p.obs_lm.shape[0], p.points.shape[0]
    want = ba.optimize(p, *args)
    counts = Counts()
    for _ in range(4):
        got = ba.optimize(p, *args, counts=counts, obs_capacity=n_obs + 137, lm_capacity=n_lm + 23)
        assert [t.shape for t in got] == [t.shape for t in want] == [(6, 4, 4), (n_lm, 3), (6,)]
        assert worst(got, want) <= 1e-10
    assert counts.read("graph_captures", "graph_replays") == (1, 2)
    assert float(want[2][-1]) < 0.5 * float(ba.total_cost(p, delta))
    q = ba._pad(p, n_obs + 137, n_lm + 23)
    assert not bool(q.obs_valid[n_obs:].any())
    assert int(q.obs_lm.max()) == n_lm + 22 and int(q.obs_cam[n_obs:].max()) == 5
    assert torch.equal(ba._lm(q, *args)[1][n_lm:], q.points[n_lm:])


def test_capacities_at_or_below_the_counts():
    """Off the card a global call given capacities runs unpadded, bit for
    bit the call without them; a capacity equal to the count pads nothing,
    None stands for the count, and one below it raises."""
    p = problem(1)
    n_obs, n_lm = p.obs_lm.shape[0], p.points.shape[0]
    assert ba._pad(p, n_obs, n_lm) is p
    assert ba._capacities(p, None, None) == (n_obs, n_lm)
    assert ba._capacities(p, n_obs + 3, None) == (n_obs + 3, n_lm)
    want = ba.optimize(p, *ARGS)
    for caps in ((n_obs, n_lm), (n_obs, None), (None, n_lm), (n_obs + 50, n_lm + 9)):
        got = ba.optimize(p, *ARGS, obs_capacity=caps[0], lm_capacity=caps[1])
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match=f"obs_capacity {n_obs - 1}"):
        ba.optimize(p, *ARGS, obs_capacity=n_obs - 1)
    with pytest.raises(ValueError, match=f"lm_capacity {n_lm - 1}"):
        ba.optimize(p, *ARGS, obs_capacity=n_obs + 5, lm_capacity=n_lm - 1)


def test_problems_of_different_counts_share_a_key():
    """Two problems of six cameras with different observation and landmark
    counts share a key once padded to one capacity, and not before; other
    LM arguments or another gauge make another key."""
    a, b = problem(2, lms=70), problem(3, lms=90)
    assert a.obs_lm.shape != b.obs_lm.shape
    key = [ba._graph_key(ba._pad(p, 500, 120), ARGS) for p in (a, b)]
    assert key[0] == key[1]
    assert ba._graph_key(a, ARGS) != ba._graph_key(b, ARGS)
    q = ba._pad(a, 500, 120)
    assert ba._graph_key(q, (5,) + ARGS[1:]) != key[0]
    assert ba._graph_key(q._replace(n_fixed_cams=2), ARGS) != key[0]
    assert key[0][1] == (torch.device("cpu"), torch.float64, (6, 4, 4))
    assert key[0][3:5] == ((torch.device("cpu"), torch.int64, (500,)),) * 2


class _FakeEvent:
    def __init__(self):
        self.synced = 0

    def synchronize(self):
        self.synced += 1


class _FakeDevice:
    def __init__(self, device):
        self.device = device
        self.done = _FakeEvent()
        self.last = self.key = self.graph = None
        self.run = 0


class _EagerGraph:
    """Stands in for a captured graph on the CPU: its replay runs the
    call's steps eagerly on the inputs it is given."""

    made = 0

    def __init__(self, p, args, dev):
        type(self).made += 1
        self.n_fixed, self.args = p.n_fixed_cams, args

    def replay(self, inputs):
        return ba._lm(ba.BAProblem(*inputs, self.n_fixed), *self.args)


@pytest.fixture()
def fake_graphs(monkeypatch):
    """BA's graph cache with the stand-in graph, reached by CPU tensors."""
    graphs = cuda_graphs.Graphs()
    graphs.new_device = _FakeDevice
    monkeypatch.setattr(ba, "_GRAPHS", graphs)
    monkeypatch.setattr(ba, "_Graph", _EagerGraph)
    monkeypatch.setattr(ba, "_on_card", lambda p: True)
    monkeypatch.setattr(_EagerGraph, "made", 0)
    return graphs


def test_batched_problems_are_never_padded_or_keyed(fake_graphs):
    """A batch of two problems given capacities runs as it is, eagerly: the
    call without capacities' answer bit for bit, and the cache untouched."""
    p = problem(4)
    batch = p._replace(poses=torch.stack([p.poses, p.poses.flip(0)]),
                       points=torch.stack([p.points, p.points + 0.1]),
                       obs_uv=torch.stack([p.obs_uv] * 2), obs_valid=torch.stack([p.obs_valid] * 2))
    want = ba.optimize(batch, *ARGS)
    counts = Counts()
    for _ in range(3):
        got = ba.optimize(batch, *ARGS, counts=counts, obs_capacity=10_000, lm_capacity=1_000)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fake_graphs.devices == {} and _EagerGraph.made == 0
    assert counts.counts == {"solves": 3, "lm_steps": 3 * ARGS[0], "cg_steps": 3 * ARGS[0] * ARGS[1]}


def test_third_call_in_a_row_captures(fake_graphs):
    """A key's first two calls in a row run eagerly, its third captures and
    replays, later ones replay that graph, also after another key's eager
    calls; another key three times in a row replaces it, after the last
    replay was waited for.  Every answer is the padded eager call's."""
    a, b = problem(5, lms=70), problem(6, lms=90)
    caps = dict(obs_capacity=500, lm_capacity=120)
    counts = Counts()
    for want in ((0, 0, 1), (0, 0, 2), (1, 1, 3), (1, 2, 4)):
        got = ba.optimize(a if want[2] % 2 else b, *ARGS, counts=counts, **caps)
        assert counts.read("graph_captures", "graph_replays", "solves") == want
        assert got[1].shape == (70 if want[2] % 2 else 90, 3)
    other = (5,) + ARGS[1:]
    ba.optimize(a, *other, counts=counts, **caps)
    ba.optimize(a, *other, counts=counts, **caps)
    assert counts.read("graph_captures", "graph_replays") == (1, 2)
    ba.optimize(b, *ARGS, counts=counts, **caps)
    assert counts.read("graph_captures", "graph_replays") == (1, 3) and _EagerGraph.made == 1
    dev = fake_graphs.devices[torch.device("cpu")]
    for _ in range(3):
        got = ba.optimize(a, *other, counts=counts, **caps)
    assert counts.read("graph_captures", "graph_replays") == (2, 4)
    assert dev.done.synced == 1 and dev.key[-5:-1] == other
    assert worst(got, ba.optimize(a, *other)) <= 1e-10


class _FakePoseGraph:
    made = 0

    def __init__(self, g, args, dev):
        type(self).made += 1

    def replay(self, g):
        return g.poses


def test_pose_graph_calls_do_not_evict_ba_graph(fake_graphs, monkeypatch):
    """Pose-graph and BA calls alternate on one device, as in a loop
    sequence: each solver keeps its own graph, so BA's key captures at its
    third call and replays after every pose-graph call, and the pose
    graph's captures replace none of BA's."""
    monkeypatch.setattr(posegraph, "_Device", _FakeDevice)
    monkeypatch.setattr(posegraph, "_Graph", _FakePoseGraph)
    monkeypatch.setattr(_FakePoseGraph, "made", 0)
    monkeypatch.setattr(posegraph, "_GRAPHS", posegraph._Graphs())
    n = 8
    g = posegraph.PoseGraph(torch.eye(4).expand(n, 4, 4), torch.arange(n - 1),
                            torch.arange(1, n), torch.eye(4).expand(n - 1, 4, 4),
                            torch.ones(n - 1, dtype=torch.bool), torch.ones(n - 1))
    pg_key = posegraph._graph_key(g, (40, "dense", 50, 1e-6, 0.25))
    p = problem(7)
    counts = Counts()
    pg = []
    for _ in range(5):
        ba.optimize(p, *ARGS, counts=counts, obs_capacity=600, lm_capacity=100)
        pg.append(posegraph._GRAPHS.replay(pg_key, g, ()))
    assert counts.read("graph_captures", "graph_replays", "solves") == (1, 3, 5)
    assert [r is None for r in pg] == [True, True, False, False, False]
    assert _EagerGraph.made == 1 and _FakePoseGraph.made == 1
    cpu = torch.device("cpu")
    assert pg_key[0] == cpu and fake_graphs.devices[cpu].done.synced == 0
    assert fake_graphs.devices[cpu].key == ba._graph_key(ba._pad(p, 600, 100), ARGS)


def test_graph_counters_land_on_the_span(fake_graphs):
    """Under a profiler, each ``vo.ba_solve`` span of four calls of one key
    holds ``solves``, ``lm_steps``, ``cg_steps``, ``graph_replays`` (1 from
    the third call) and ``graph_captures`` (1 on the third alone); with no
    profiler, nothing is counted and the answer is the same."""
    p = problem(8)
    caps = dict(obs_capacity=700, lm_capacity=100)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            with tracing.span("vo.ba_solve") as stage:
                got = ba.optimize(p, *ARGS, counts=stage, **caps)
    records = [r for r in tracing.spans() if r.name == "vo.ba_solve"]
    tracing.clear()
    base = {"solves": 1, "lm_steps": ARGS[0], "cg_steps": ARGS[0] * ARGS[1]}
    assert [r.counts for r in records] == [
        dict(base, graph_replays=r, graph_captures=c) for r, c in ((0, 0), (0, 0), (1, 1), (1, 0))]
    with tracing.span("vo.ba_solve") as stage:
        assert not stage
        again = ba.optimize(p, *ARGS, counts=stage, **caps)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert tracing.spans() == []


def test_detection_drivers_load_no_vo_module():
    """The detection cells' drivers and the API they drive load none of the
    VO back-end: its solvers' graphs and padding cannot reach those cells."""
    vo = [f"feature_detector_fast_tpu_torch.models.{m}"
          for m in ("ba", "slam", "posegraph", "windowed_ba")]
    code = ("import sys\n"
            "import benchmark.drivers.detect_resident, benchmark.drivers.detect_host\n"
            "import feature_detector_fast_tpu_torch.api\n"
            f"print([m for m in {vo!r} if m in sys.modules])\n"
            "print('benchmark.drivers.fast_common' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True).stdout.split("\n")
    assert out[:2] == ["[]", "True"]


# ---- on the card ----------------------------------------------------------


@pytest.fixture()
def device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    monkeypatch.setattr(ba, "_GRAPHS", cuda_graphs.Graphs())
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [0.0, 0.01])
def test_replay_equals_the_padded_eager_call(device, delta):
    """A 16-camera float64 problem (about 4,500 observations) padded to
    8192 observations and 512 landmarks: the two eager calls, the capturing
    call and two later replays each lie within 1e-9 relative of the padded
    eager answer, poses, points and costs.  At 4 LM x 12 CG steps two eager
    calls agree to about 1e-13; at the cell's 20 x 40 they part by up to
    2e-4 on an H100, where CG at its rounding floor amplifies the atomics'
    order, so no tolerance there tells a faulty replay from a sound one."""
    p = problem(10, cams=16, lms=400, device=device)
    args = ARGS[:3] + (delta,)
    want = ba._lm(ba._pad(p, 8192, 512), *args)
    want = (want[0], want[1][:400], want[2])
    counts = Counts()
    for _ in range(5):
        got = ba.optimize(p, *args, counts=counts, obs_capacity=8192, lm_capacity=512)
        assert worst(got, want) <= 1e-9
    assert counts.read("graph_captures", "graph_replays", "solves") == (1, 3, 5)


@pytest.mark.cuda
def test_replay_takes_new_inputs(device):
    """Captured with problem a, the graph answers b (other counts, one
    capacity) with b's own padded eager answer, and a again with a's: no
    static buffer keeps the capturing call's inputs."""
    a = problem(10, cams=16, lms=400, device=device)
    b = problem(11, cams=16, lms=460, device=device)
    caps = dict(obs_capacity=6000, lm_capacity=700)

    def eager(p):
        poses, points, costs = ba._lm(ba._pad(p, 6000, 700), *ARGS)
        return poses, points[:p.points.shape[0]], costs

    want_a, want_b = eager(a), eager(b)
    counts = Counts()
    for _ in range(3):
        ba.optimize(a, *ARGS, counts=counts, **caps)
    assert worst(ba.optimize(b, *ARGS, counts=counts, **caps), want_b) <= 1e-9
    assert worst(ba.optimize(a, *ARGS, counts=counts, **caps), want_a) <= 1e-9
    assert counts.read("graph_captures", "graph_replays", "solves") == (1, 3, 5)
    assert ba._GRAPHS.devices[device].key[0] == device


@pytest.mark.cuda
def test_counts_over_four_calls(device):
    """``graph_captures`` / ``graph_replays`` / ``solves`` read 0/0/1,
    0/0/2, 1/1/3, 1/2/4 over four calls of one key."""
    p = problem(12, device=device)
    counts = Counts()
    for want in ((0, 0, 1), (0, 0, 2), (1, 1, 3), (1, 2, 4)):
        ba.optimize(p, *ARGS, counts=counts, obs_capacity=800, lm_capacity=200)
        assert counts.read("graph_captures", "graph_replays", "solves") == want
    assert counts.counts["lm_steps"] == 4 * ARGS[0]


def _loop_sequence(n: int = 5, n_pts: int = 200):
    """(pair data, one loop pair) of a short synthetic trajectory whose
    first and last frames see the same landmarks (slot i is landmark i)."""
    rng = np.random.default_rng(0)
    lm = np.stack([rng.uniform(-6, 10, n_pts), rng.uniform(-4, 4, n_pts),
                   rng.uniform(4, 22, n_pts)], -1)
    poses = [np.eye(4)]
    for k in range(n - 1):
        step = lie.se3_exp(torch.tensor([0.03 * np.sin(k), 0.0, 0.4, 0.0, 0.06, 0.0],
                                        dtype=torch.float64)).numpy()
        poses.append(poses[-1] @ step)
    projs = []
    for T in poses:
        Xc = (np.linalg.inv(T) @ np.concatenate([lm, np.ones((n_pts, 1))], 1).T).T[:, :3]
        p = Xc[:, :2] / np.maximum(Xc[:, 2:3], 1e-9)
        projs.append((p + rng.normal(0.0, 2e-3, p.shape),
                      (Xc[:, 2] > 0.5) & (np.abs(p) < 0.7).all(1)))
    pairs = [(projs[k][0], projs[k + 1][0], projs[k][1] & projs[k + 1][1]) for k in range(n - 1)]
    seen = projs[0][1] & projs[n - 1][1]
    loop = (0, n - 1, projs[0][0], projs[n - 1][0], seen,
            np.where(seen, np.arange(n_pts), -1).astype(np.int32))
    return pairs, loop


@pytest.mark.cuda
def test_refine_with_ba_replays_from_the_third_solve(device):
    """Two runs of one loop sequence on the card: the loop route's four
    global solves (two rounds a run) share one key, so the first two run
    eagerly and from the third solve on ``ba_replay_pct`` (graph replays
    over solves, on the ``vo.ba_solve`` spans) reads 100."""
    pairs, loop = _loop_sequence()
    cfg = slam.VOConfig(ransac_hypotheses=32)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            slam.run_vo_matches(pairs, cfg, loop_pairs=[loop], ba_refine=True, device=device)
    records = [r for r in tracing.spans() if r.name == "vo.ba_solve"]
    tracing.clear()
    assert [r.counts["solves"] for r in records] == [1] * 4
    assert [r.counts.get("graph_replays", 0) for r in records] == [0, 0, 1, 1]
    assert [r.counts.get("graph_captures", 0) for r in records] == [0, 0, 1, 0]
    later = records[2:]
    assert 100.0 * sum(r.counts["graph_replays"] for r in later) / len(later) == 100.0
