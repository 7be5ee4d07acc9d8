"""Global bundle adjustment's solves answered by a CUDA graph's replay, in
percent: the counts ``graph_replays`` and ``solves`` that ``ba.optimize``
puts on the program's ``vo.ba_solve`` spans in the traced sub-window.  None
where the program counts no solves or no ``graph_replays`` (a program
without BA's CUDA graph)."""

from benchmark.metrics import _spans


def read(run):
    j = _spans.joined(run)
    stage = j and j.stages.get("vo.ba_solve")
    if not stage or not stage.counts.get("solves") or "graph_replays" not in stage.counts:
        return None
    return 100.0 * stage.counts["graph_replays"] / stage.counts["solves"]
