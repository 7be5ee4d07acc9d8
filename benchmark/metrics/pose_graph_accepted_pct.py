"""The pose graph's accepted Levenberg-Marquardt steps over the steps it
took, in percent: the counts ``steps_accepted`` and ``steps`` that
``posegraph.optimize`` puts on the program's ``vo.pose_graph`` spans in the
traced sub-window."""

from benchmark.metrics import _spans


def read(run):
    j = _spans.joined(run)
    stage = j and j.stages.get("vo.pose_graph")
    if not stage or not stage.counts.get("steps"):
        return None
    return 100.0 * stage.counts.get("steps_accepted", 0) / stage.counts["steps"]
