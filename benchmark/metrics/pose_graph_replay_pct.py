"""The pose graph's calls answered by a CUDA graph's replay, in percent:
the counts ``graph_replays`` and ``calls`` that ``posegraph.optimize`` puts
on the program's ``vo.pose_graph`` spans in the traced sub-window.  None
where the program counts no calls."""

from benchmark.metrics import _spans


def read(run):
    j = _spans.joined(run)
    stage = j and j.stages.get("vo.pose_graph")
    if not stage or not stage.counts.get("calls"):
        return None
    return 100.0 * stage.counts.get("graph_replays", 0) / stage.counts["calls"]
