"""The device-idle share of the program's ``vo.pose_graph`` spans
(``posegraph.optimize`` and the readback of its poses) in the traced
sub-window: the part of their intervals in which no kernel, copy or set ran,
over their length, in percent."""

from benchmark.metrics import _spans


def read(run):
    return _spans.idle_pct(run, "vo.pose_graph")
