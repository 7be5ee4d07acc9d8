"""``yardstick.spans``: the program's spans joined with a synthetic trace,
and the span metrics read from it."""

import time
from typing import Dict, NamedTuple

import pytest
import torch

from benchmark import catalog, core
from benchmark.yardstick import spans as spans_lib
from benchmark.yardstick.trace import Trace

from .conftest import spec, tiny


class Rec(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int = -1
    counts: Dict[str, int] = {}


def trace(busy, bench=((0, 40),), requests=1):
    return Trace(requests, requests, 40e-9, [("k", s, e) for s, e in busy],
                 [("bench.request", s, e) for s, e in bench])


def test_idle_inside_and_outside_a_span():
    """Busy [0, 10] and [20, 30], a span over [5, 25]: 10 ns idle inside it,
    none of the window's idle [10, 20] outside it, [30, 40] outside."""
    j = spans_lib.join(trace([(0, 10), (20, 30)], bench=((0, 30),)), [Rec(0, "s", 5, 25)])
    assert j.stages["s"].idle_ns == 10 and j.stages["s"].host_ns == 20
    assert j.idle_ns == 10 and j.idle_outside_ns == 0
    j = spans_lib.join(trace([(0, 10), (20, 30)]), [Rec(0, "s", 5, 25)])
    assert j.window == (0, 40) and j.idle_ns == 20 and j.idle_outside_ns == 10


def test_self_time_counts_and_calls():
    recs = [Rec(1, "a.b", 2, 6, parent=0, counts={"steps": 3}), Rec(2, "a.b", 7, 9, parent=0,
                                                                    counts={"steps": 1}),
            Rec(0, "a", 1, 20)]
    j = spans_lib.join(trace([(4, 8)]), recs)
    a, b = j.stages["a"], j.stages["a.b"]
    assert (a.calls, a.host_ns, a.self_ns) == (1, 19, 13)
    assert (b.calls, b.host_ns, b.self_ns, b.counts) == (2, 6, 6, {"steps": 4})
    # idle inside: a [1, 20] less busy [4, 8]; a.b [2, 6] + [7, 9] less [4, 6] + [7, 8]
    assert a.idle_ns == 15 and b.idle_ns == 3
    assert j.idle_ns == 36 and j.idle_outside_ns == 36 - 15
    assert any(line.startswith("span a.b: calls 2") for line in j.lines())


def test_records_outside_the_window_are_left_out():
    j = spans_lib.join(trace([], bench=((100, 200),)), [Rec(0, "old", 10, 20),
                                                         Rec(1, "new", 120, 150)])
    assert set(j.stages) == {"new"} and j.idle_ns == 100 and j.idle_outside_ns == 70


@pytest.mark.parametrize("s,e,want", [(0, 5, 5), (3, 13, 3), (14, 25, 7), (0, 100, 19),
                                      (30, 40, 0), (5, 12, 0), (16, 20, 0), (21, 22, 1)])
def test_cover_within(s, e, want):
    merged = spans_lib.merge([(20, 30), (0, 5), (12, 14), (13, 16)])
    assert merged == [(0, 5), (12, 16), (20, 30)]
    assert spans_lib.Cover(merged).within(s, e) == want


@pytest.mark.parametrize("name,metrics", [
    ("fast-1080p.host-b16", {"split_ms_per_batch", "h2d_host_ms_per_batch"}),
    ("fast-1080p.resident-b16", {"launch_us_per_batch"}),
    ("vo-tum-vga.odometry", {"pose_graph_accepted_pct"}),
])
def test_span_metrics_read_in_a_traced_cpu_run(name, metrics):
    """A traced run on the CPU reads the host-side span metrics of its cell;
    the device-side ones find no device events there and read nothing."""
    cell = tiny(name)
    line = core.measure(cell, seed=2**31 + 7, seconds=0.2, trace=True,
                        device=torch.device("cpu"), t_start=time.perf_counter())
    got = line["metrics"]
    assert metrics <= set(got), got
    assert all(got[m]["value"] >= 0 for m in metrics)
    assert not {"pose_graph_idle_pct", "estimate_pairs_idle_pct",
                "idle_outside_spans_pct"} & set(got)
    if name == "vo-tum-vga.odometry":
        assert 0 <= got["pose_graph_accepted_pct"]["value"] <= 100


def test_span_metrics_read_nothing_untraced():
    run = core.Run(catalog.cell(spec(), "fast-1080p.resident-b16"), None, 0.0, [], 0, 1.0,
                   None, {})
    for m in ("launch_us_per_batch", "idle_outside_spans_pct", "pose_graph_accepted_pct"):
        assert catalog.reader(m).read(run) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """Over a program that records no spans (an older port), every span
    metric reads None and none raises."""
    from benchmark.metrics import _spans

    monkeypatch.setattr(_spans, "_records", None)
    run = core.Run(catalog.cell(spec(), "vo-tum-vga.odometry"), None, 0.0, [(0.0, 1.0)], 64,
                   1.0, None, {}, trace=trace([(0, 10)]))
    for m in ("pose_graph_idle_pct", "estimate_pairs_idle_pct", "pose_graph_accepted_pct",
              "idle_outside_spans_pct", "launch_us_per_batch", "split_ms_per_batch",
              "h2d_host_ms_per_batch"):
        assert catalog.reader(m).read(run) is None, m
