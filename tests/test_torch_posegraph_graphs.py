"""``posegraph.optimize``'s CUDA graphs: eager on the CPU, replayed on the card.

On the CPU every call runs eagerly and only ``calls`` is counted.  The
graph cache's bookkeeping (a capture at a key's ``CAPTURE_AT``-th call in
a row on a device, one graph a device) is held here with stand-ins
for the CUDA parts.  The tests marked ``cuda`` run the real
graphs on a card and skip where there is none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_posegraph_graphs.py -q

There a replay equals the eager call bit for bit: the same kernels in the
same order on the same inputs.
"""

import threading

import numpy as np
import pytest
import torch

from feature_detector_fast_tpu_torch.models import lie, posegraph
from feature_detector_fast_tpu_torch.utils import precision

JOIN_S = 300.0


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
