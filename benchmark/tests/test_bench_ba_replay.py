"""``ba_replay_pct`` on synthetic spans: the share of global BA's solves a
CUDA graph's replay answered, and nothing from a program that counts no
solves or no replays."""

import pytest

from benchmark import catalog, core

from .conftest import spec
from .test_bench_replay import Rec, traced_run


@pytest.mark.parametrize("counts,want", [
    ([{"solves": 1, "graph_replays": 1, "graph_captures": 1}, {"solves": 1, "graph_replays": 1}],
     100.0),
    ([{"solves": 1, "graph_replays": 0}, {"solves": 1, "graph_replays": 1}], 50.0),
    ([{"solves": 1, "graph_replays": 0}, {"solves": 1, "graph_replays": 0}], 0.0),
    ([{"solves": 1, "lm_steps": 20}, {"solves": 1, "lm_steps": 20}], None),
    ([{"lm_steps": 20}, {"lm_steps": 20}], None),
])
def test_replay_share_of_solves(monkeypatch, counts, want):
    """Σ ``graph_replays`` ÷ Σ ``solves`` over the window's ``vo.ba_solve``
    spans; spans without ``graph_replays`` (a program before BA's graph)
    or without ``solves`` read nothing."""
    recs = [Rec(2 * k, "vo.ba_solve", 5 + 20 * k, 15 + 20 * k, counts=c)
            for k, c in enumerate(counts)]
    run = traced_run(monkeypatch, recs + [Rec(9, "vo.pose_graph", 1, 4, counts={"calls": 1})])
    assert catalog.reader("ba_replay_pct").read(run) == want


def test_no_ba_span_reads_nothing(monkeypatch):
    run = traced_run(monkeypatch, [Rec(0, "vo.pose_graph", 1, 4, counts={"graph_replays": 1})])
    assert catalog.reader("ba_replay_pct").read(run) is None
    untraced = core.Run(catalog.cell(spec(), "vo-tum-vga.odometry"), None, 0.0, [], 0, 1.0,
                        None, {})
    assert catalog.reader("ba_replay_pct").read(untraced) is None
