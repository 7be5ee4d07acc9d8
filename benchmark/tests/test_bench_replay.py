"""``pose_graph_replay_pct`` on synthetic spans: the share of the pose
graph's calls a CUDA graph's replay answered, and nothing from a program
that counts no calls."""

import time
from typing import Dict, NamedTuple

import pytest
import torch

from benchmark import catalog, core
from benchmark.metrics import _spans
from benchmark.yardstick.trace import Trace

from .conftest import spec, tiny


class Rec(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int = -1
    counts: Dict[str, int] = {}


class Records(list):
    dropped = 0


def traced_run(monkeypatch, records):
    monkeypatch.setattr(_spans, "_records", lambda: Records(records))
    trace = Trace(2, 128, 40e-9, [("k", 0, 10)], [("bench.request", 0, 20),
                                                   ("bench.request", 20, 40)])
    return core.Run(catalog.cell(spec(), "vo-tum-vga.odometry"), None, 0.0, [(0.0, 1.0)], 64,
                    1.0, None, {}, trace=trace)


@pytest.mark.parametrize("counts,want", [
    ([{"calls": 1, "graph_replays": 1}, {"calls": 1, "graph_replays": 1, "graph_captures": 1}],
     100.0),
    ([{"calls": 1}, {"calls": 1, "graph_replays": 1}], 50.0),
    ([{"calls": 1, "steps": 10}, {"calls": 1, "steps": 10}], 0.0),
    ([{"steps": 10, "steps_accepted": 3}, {"steps": 10, "steps_accepted": 4}], None),
])
def test_replay_share_of_calls(monkeypatch, counts, want):
    """Σ ``graph_replays`` ÷ Σ ``calls`` over the window's ``vo.pose_graph``
    spans; spans without ``calls`` (a program before the graphs) read
    nothing."""
    recs = [Rec(2 * k, "vo.pose_graph", 5 + 20 * k, 15 + 20 * k, counts=c)
            for k, c in enumerate(counts)]
    run = traced_run(monkeypatch, recs + [Rec(9, "vo.chain", 1, 4)])
    assert catalog.reader("pose_graph_replay_pct").read(run) == want


def test_no_pose_graph_span_reads_nothing(monkeypatch):
    run = traced_run(monkeypatch, [Rec(0, "vo.chain", 1, 4, counts={"calls": 1})])
    assert catalog.reader("pose_graph_replay_pct").read(run) is None
    untraced = core.Run(catalog.cell(spec(), "vo-tum-vga.odometry"), None, 0.0, [], 0, 1.0,
                        None, {})
    assert catalog.reader("pose_graph_replay_pct").read(untraced) is None


def test_a_traced_cpu_run_reads_no_replay():
    """On the CPU the pose graph never replays: the metric reads 0 in a
    traced run of the odometry cell at a tiny size."""
    line = core.measure(tiny("vo-tum-vga.odometry"), seed=2**31 + 11, seconds=0.2, trace=True,
                        device=torch.device("cpu"), t_start=time.perf_counter())
    assert line["metrics"]["pose_graph_replay_pct"]["value"] == 0.0
