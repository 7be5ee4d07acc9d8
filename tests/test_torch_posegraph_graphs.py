"""``posegraph.optimize``'s CUDA graphs: eager on the CPU, replayed on the card.

On the CPU every call runs eagerly and only ``calls`` is counted.  The
graph cache's bookkeeping (a capture at a key's ``CAPTURE_AT``-th call in
a row on a device, one graph a device, one key for loop graphs padded to
one edge capacity) is held here with stand-ins for the CUDA parts.  The
tests marked ``cuda`` run the real graphs on a card and skip where there
is none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_posegraph_graphs.py -q

There a replay equals the eager call bit for bit: the same kernels in the
same order on the same inputs.
"""

import os
import threading

import numpy as np
import pytest
import torch

from benchmark.reference import se3
from benchmark.reference import slam as ref_slam
from feature_detector_fast_tpu_torch.models import lie, posegraph
from feature_detector_fast_tpu_torch.utils import precision

JOIN_S = 300.0
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "loop_graphs_vga64.npz")
#: The SLAM cell's loop graph call: 40 robust dense steps.
LOOP_ARGS = (40, "dense", 50, 1e-6, 0.25)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two host threads: the cell-size solves below, beside other test
    workers each on every core, ran 20-30x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def chain(n: int, seed: int, loops: int = 0, dtype=torch.float64, device="cpu"
          ) -> posegraph.PoseGraph:
    """An n-pose odometry chain integrated from noisy steps (n - 1 edges),
    plus ``loops`` edges between random poses, every other one rotated by
    1 rad: outliers for the robust cost."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((n, 6))
    xi[:, 0], xi[:, 5] = 0.3, 2 * np.pi / n
    steps = lie.se3_exp(torch.from_numpy(xi))
    noisy = lie.se3_exp(torch.from_numpy(xi + rng.normal(0, 0.02, xi.shape)))
    truth, poses = [torch.eye(4, dtype=torch.float64)], [torch.eye(4, dtype=torch.float64)]
    for k in range(n - 1):
        truth.append(truth[-1] @ steps[k])
        poses.append(poses[-1] @ noisy[k])
    truth = torch.stack(truth)
    ei = list(range(n - 1))
    ej = list(range(1, n))
    meas = [steps[k] for k in range(n - 1)]
    for k in range(loops):
        i, j = sorted(rng.choice(n, 2, replace=False))
        z = torch.linalg.inv(truth[i]) @ truth[j]
        if k % 2:
            z = z @ lie.se3_exp(torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0],
                                             dtype=torch.float64))
        ei.append(int(i))
        ej.append(int(j))
        meas.append(z)
    e = len(ei)
    return posegraph.PoseGraph(
        torch.stack(poses).to(device, dtype), torch.tensor(ei, device=device),
        torch.tensor(ej, device=device), torch.stack(meas).to(device, dtype),
        torch.ones(e, dtype=torch.bool, device=device),
        torch.from_numpy(rng.uniform(0.5, 1.5, e)).to(device, dtype))


def cell_graph(which: str, device="cpu") -> posegraph.PoseGraph:
    """Loop graph ``which`` ("a": 259 edges, "b": 309) of the SLAM cell's
    64 frames, float32, as the program assembled it on the card."""
    data = np.load(DATA)
    return posegraph.PoseGraph(*(torch.as_tensor(data[f"{which}_{k}"]).to(device)
                                 for k in posegraph.PoseGraph._fields))


@precision.matmul_highest
def eager(g: posegraph.PoseGraph, *args):
    """(poses, costs) of the eager path, as ``optimize`` runs it."""
    return posegraph._steps(g, *args, flags=False)[:2]


@pytest.mark.parametrize("solver,robust", [("dense", 0.0), ("dense", 0.25), ("cg", 0.0),
                                           ("cg", 0.25)])
def test_cpu_calls_run_eagerly(solver, robust):
    """CPU tensors never reach the graph cache: three calls of one key give
    the eager answer each time, count ``calls`` and no replay or capture."""
    g = chain(10, 0, loops=3)
    args = (6, solver, 12, 1e-6, robust)
    want = eager(g, *args)
    devices = dict(posegraph._GRAPHS.devices)
    counts = Counts()
    for k in range(3):
        got = posegraph.optimize(g, *args, counts=counts)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert counts.read("graph_captures", "graph_replays", "calls") == (0, 0, k + 1)
    assert counts.counts["steps"] == 3 * 6
    assert posegraph._GRAPHS.devices == devices


def test_edge_capacity_at_or_below_the_edge_count():
    """A capacity equal to the edge count leaves the call as it is, bit
    for bit; one below it raises."""
    g = chain(10, 0, loops=3)
    args = (6, "dense", 12, 1e-6, 0.25)
    want = posegraph.optimize(g, *args)
    assert same(posegraph.optimize(g, *args, edge_capacity=12), want)
    with pytest.raises(ValueError, match="edge_capacity 11"):
        posegraph.optimize(g, *args, edge_capacity=11)


def test_padded_edges_are_counted():
    """While a profiler records, ``edges`` counts the graph's edges and
    ``edge_slots`` the slots after padding; the poses and costs keep the
    unpadded call's shapes."""
    g = chain(10, 0, loops=3)
    counts = Counts()
    poses, costs = posegraph.optimize(g, 2, "dense", robust_delta=0.25, counts=counts,
                                      edge_capacity=16)
    assert poses.shape == (10, 4, 4) and costs.shape == (2,)
    posegraph.optimize(g, 2, "dense", robust_delta=0.25, counts=counts)
    assert counts.read("edges", "edge_slots", "calls") == (24, 28, 2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("which", ["a", "b"])
def test_padded_loop_graph_is_the_same_graph(which, dtype):
    """The cell's loop graphs with their edges padded to 512 slots, as
    ``run_vo_matches`` pads them, at the cell's 40 robust steps: in float64
    the padded call's poses lie within 1e-9 of the unpadded call's and its
    costs within rtol 1e-9 (the padded rows are exact zeros; a, b: poses
    5.5e-12, 7.0e-14 apart, costs 4.6e-13, 3.1e-12); in float32 it still
    follows the float64 reference within 1e-3 of a radian in every link and
    of the path, as the unpadded call does (links 3.6e-6, 1.1e-4 read)."""
    g = cell_graph(which)
    g = posegraph.PoseGraph(*(t.to(dtype) if t.is_floating_point() else t for t in g))
    got, costs = posegraph.optimize(g, *LOOP_ARGS, edge_capacity=512)
    if dtype == torch.float64:
        want, want_costs = posegraph.optimize(g, *LOOP_ARGS)
        assert float((got - want).abs().max()) < 1e-9
        np.testing.assert_allclose(costs.numpy(), want_costs.numpy(), rtol=1e-9)
        return
    want, _ = ref_slam.pose_graph(*g, 40, 0.25)
    got = got.double()
    link = se3.angle((got[:-1, :3, :3].transpose(1, 2) @ got[1:, :3, :3]).transpose(1, 2)
                     @ (want[:-1, :3, :3].transpose(1, 2) @ want[1:, :3, :3]))
    path = float(torch.linalg.vector_norm(want[1:, :3, 3] - want[:-1, :3, 3], dim=1).sum())
    centre = torch.linalg.vector_norm(got[:, :3, 3] - want[:, :3, 3], dim=1) / path
    assert float(link.max()) < 1e-3 and float(centre.max()) < 1e-3


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


class _FakeGraph:
    """Stands in for a captured graph: its replay returns the call's own
    poses and says which capture it was."""

    made = 0

    def __init__(self, g, args, dev):
        type(self).made += 1
        self.number, self.dev = type(self).made, dev

    def replay(self, g):
        return g.poses, self.number


@pytest.fixture()
def fake_graphs(monkeypatch):
    monkeypatch.setattr(posegraph, "_Device", _FakeDevice)
    monkeypatch.setattr(posegraph, "_Graph", _FakeGraph)
    monkeypatch.setattr(_FakeGraph, "made", 0)
    return posegraph._Graphs()


def test_graph_cache_captures_on_the_third_call_in_a_row(fake_graphs):
    """A key's first two calls in a row are eager (None), its third captures
    and replays, later ones replay that graph, also after another key's
    eager call; another key three times in a row replaces the graph."""
    assert posegraph.CAPTURE_AT == 3
    g = chain(4, 1)
    a, b = ("dev", torch.float64, 4, 3, 10), ("dev", torch.float64, 4, 3, 40)
    assert fake_graphs.replay(a, g, ()) is None
    assert fake_graphs.replay(a, g, ()) is None
    assert fake_graphs.replay(a, g, ()) == ((g.poses, 1), True)
    assert fake_graphs.replay(a, g, ()) == ((g.poses, 1), False)
    assert fake_graphs.replay(b, g, ()) is None
    assert fake_graphs.replay(b, g, ()) is None
    assert fake_graphs.replay(a, g, ()) == ((g.poses, 1), False)
    assert fake_graphs.replay(b, g, ()) is None
    assert fake_graphs.replay(b, g, ()) is None
    dev = fake_graphs.devices["dev"]
    assert dev.done.synced == 0
    assert fake_graphs.replay(b, g, ()) == ((g.poses, 2), True)
    assert dev.done.synced == 1 and dev.key == b
    assert fake_graphs.replay(a, g, ()) is None
    assert len(fake_graphs.devices) == 1


@pytest.mark.parametrize("capacity", [512, None])
def test_padded_loop_graphs_share_a_key(fake_graphs, capacity):
    """The cell's loop graphs a, b, a: padded to 512 edge slots they share
    one key, so the third call captures and every later one replays;
    unpadded (259, 309 edges) their keys alternate and never capture."""
    a, b = cell_graph("a"), cell_graph("b")
    calls = [posegraph._pad_edges(g, capacity) for g in (a, b, a, b, a)]
    keys = [posegraph._graph_key(g, LOOP_ARGS) for g in calls]
    got = [fake_graphs.replay(k, g, LOOP_ARGS) for k, g in zip(keys, calls)]
    if capacity is None:
        assert len(set(keys)) == 2 and got == [None] * 5
    else:
        assert len(set(keys)) == 1
        assert got[:2] == [None, None] and got[2] == ((calls[2].poses, 1), True)
        assert got[3:] == [((calls[3].poses, 1), False), ((calls[4].poses, 1), False)]


def test_graph_cache_keeps_one_graph_a_device(fake_graphs):
    """Keys that alternate, or come twice in a row, never capture; nine
    keys each called three times in a row leave one graph a device, each
    replaced after its device's last replay was waited for."""
    g = chain(4, 2)
    for _ in range(3):
        for key in (("dev", 0), ("dev", 1)):
            assert fake_graphs.replay(key, g, ()) is None
    for k in range(3):
        assert fake_graphs.replay(("dev", "twice", k), g, ()) is None
        assert fake_graphs.replay(("dev", "twice", k), g, ()) is None
    assert fake_graphs.devices["dev"].graph is None
    keys = [("dev", k) for k in range(9)] + [("other", 0)]
    for key in keys:
        assert fake_graphs.replay(key, g, ()) is None
        assert fake_graphs.replay(key, g, ()) is None
        assert fake_graphs.replay(key, g, ())[1]
    assert {d: dev.key for d, dev in fake_graphs.devices.items()} == {
        "dev": keys[8], "other": keys[9]}
    assert fake_graphs.devices["dev"].done.synced == 8
    assert _FakeGraph.made == 10


# ---- on the card ----------------------------------------------------------


@pytest.fixture()
def device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    monkeypatch.setattr(posegraph, "_GRAPHS", posegraph._Graphs())
    return torch.device("cuda", 0)


def same(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,loops,args", [
    ("odometry", 64, 0, (10, "dense", 50, 1e-6, 0.0)),
    ("loops", 64, 12, (40, "dense", 50, 1e-6, 0.25)),
    ("cg", 24, 2, (3, "cg", 12, 1e-6, 0.0)),
])
def test_replay_equals_eager(device, name, n, loops, args):
    """The odometry cell's problem (64 poses, 63 edges, 10 dense steps,
    float32), a robust loop graph at 40 steps and a CG call: the eager
    calls, the capturing call and later replays give the eager answer
    exactly, poses and costs."""
    g = chain(n, 3, loops=loops, dtype=torch.float32, device=device)
    want = eager(g, *args)
    counts = Counts()
    for _ in range(5):
        assert same(posegraph.optimize(g, *args, counts=counts), want)
    assert counts.read("graph_captures", "graph_replays", "calls") == (1, 3, 5)


@pytest.mark.cuda
def test_padded_replay_takes_another_graph(device):
    """The cell's loop graph a, padded to 512 slots, captured at its third
    call; then b (309 edges, padded to the same 512) is answered by that
    graph's replay, and equals b's padded eager call bit for bit."""
    a, b = cell_graph("a", device), cell_graph("b", device)
    want = eager(posegraph._pad_edges(b, 512), *LOOP_ARGS)
    counts = Counts()
    for _ in range(3):
        posegraph.optimize(a, *LOOP_ARGS, counts=counts, edge_capacity=512)
    assert same(posegraph.optimize(b, *LOOP_ARGS, counts=counts, edge_capacity=512), want)
    assert counts.read("graph_captures", "graph_replays", "calls") == (1, 2, 4)
    assert counts.read("edges", "edge_slots") == (3 * 259 + 309, 4 * 512)


@pytest.mark.cuda
def test_replay_takes_new_inputs(device):
    """A replay of a key with other values gives their own eager answer: no
    static buffer keeps the capturing call's inputs."""
    args = (10, "dense", 50, 1e-6, 0.0)
    a, b = (chain(64, s, dtype=torch.float32, device=device) for s in (4, 5))
    want_a, want_b = eager(a, *args), eager(b, *args)
    assert not torch.equal(want_a[0], want_b[0])
    posegraph.optimize(a, *args)
    posegraph.optimize(a, *args)
    assert same(posegraph.optimize(a, *args), want_a)  # captured with a's values
    assert same(posegraph.optimize(b, *args), want_b)
    assert same(posegraph.optimize(a, *args), want_a)
    assert posegraph._GRAPHS.devices[device].key[0] == device


@pytest.mark.cuda
def test_threads_replay_one_key(device):
    """Four threads call one key seen twice in a row, each with its own
    chain: one of them captures, and every call gives that chain's eager
    answer."""
    args = (10, "dense", 50, 1e-6, 0.0)
    inputs = [chain(64, 10 + i, dtype=torch.float32, device=device) for i in range(4)]
    wants = [eager(g, *args) for g in inputs]
    posegraph.optimize(inputs[0], *args)
    posegraph.optimize(inputs[0], *args)
    results, errors = [None] * 4, []

    def work(i: int) -> None:
        try:
            results[i] = [posegraph.optimize(inputs[i], *args) for _ in range(3)]
            torch.cuda.synchronize()
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert all(same(r, wants[i]) for i in range(4) for r in results[i])


@pytest.mark.cuda
def test_capture_beside_eager_threads(device):
    """One thread captures and replays a key while three others run the
    eager path of other keys and float32 matmuls on the card, over the
    capture's workspace clears, each reading its results back (a sync of
    its own stream): every result is its single-thread answer."""
    args = (10, "dense", 50, 1e-6, 0.0)
    g = chain(64, 20, dtype=torch.float32, device=device)
    others = [chain(40 + i, 21 + i, loops=4, dtype=torch.float32, device=device)
              for i in range(3)]
    gen = torch.Generator().manual_seed(22)
    mats = [torch.randn(512, 512, generator=gen).to(device) for _ in range(3)]
    want = eager(g, *args)
    wants = [(eager(o, *args), m @ m) for o, m in zip(others, mats)]
    torch.cuda.synchronize()
    running, stop, errors, bad = threading.Barrier(4), threading.Event(), [], []

    def eager_work(i: int) -> None:
        try:
            running.wait(JOIN_S)
            while not stop.is_set():
                got, prod = eager(others[i], *args), mats[i] @ mats[i]
                if not (same(got, wants[i][0]) and torch.equal(prod, wants[i][1])):
                    bad.append(i)
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=eager_work, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    counts = Counts()
    try:
        running.wait(JOIN_S)
        results = [posegraph.optimize(g, *args, counts=counts) for _ in range(5)]
        torch.cuda.synchronize()
    finally:
        stop.set()
        for t in threads:
            t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads) and not errors and not bad, (errors, bad)
    assert counts.read("graph_captures", "graph_replays", "calls") == (1, 3, 5)
    assert all(same(r, want) for r in results)


@pytest.mark.cuda
def test_nine_keys_leave_one_graph(device):
    """Nine keys, each called four times in a row: each third call
    captures in place of the last graph, and every call gives the eager
    answer; a tenth key differing only in its index dtype (int32 edges) is
    a key of its own."""
    args = (2, "dense", 50, 1e-6, 0.0)
    counts = Counts()
    for n in range(3, 12):
        g = chain(n, n, dtype=torch.float32, device=device)
        want = eager(g, *args)
        for _ in range(4):
            assert same(posegraph.optimize(g, *args, counts=counts), want)
    assert counts.read("graph_captures", "graph_replays", "calls") == (9, 18, 36)
    assert len(posegraph._GRAPHS.devices) == 1
    assert posegraph._GRAPHS.devices[device].key[1:] == (
        (device, torch.float32, (11, 4, 4)),) + tuple(
        (device, t.dtype, t.shape) for t in g[1:]) + args
    narrow = g._replace(edge_i=g.edge_i.int(), edge_j=g.edge_j.int())
    want = eager(narrow, *args)
    for _ in range(3):
        assert same(posegraph.optimize(narrow, *args, counts=counts), want)
    assert counts.read("graph_captures", "graph_replays", "calls") == (10, 19, 39)
    assert posegraph._GRAPHS.devices[device].key[2] == (device, torch.int32, (10,))


@pytest.mark.cuda
def test_counts_over_four_calls(device):
    """``graph_captures`` / ``graph_replays`` / ``calls`` read 0/0/1, 0/0/2,
    1/1/3, 1/2/4; the steps are counted from the replay's acceptance
    flags, as many as the eager calls accept."""
    g = chain(16, 6, dtype=torch.float32, device=device)
    counts, accepted = Counts(), []
    for want in ((0, 0, 1), (0, 0, 2), (1, 1, 3), (1, 2, 4)):
        before = counts.counts.get("steps_accepted", 0)
        posegraph.optimize(g, 5, counts=counts)
        accepted.append(counts.counts["steps_accepted"] - before)
        assert counts.read("graph_captures", "graph_replays", "calls") == want
    assert counts.counts["steps"] == 20 and len(set(accepted)) == 1
