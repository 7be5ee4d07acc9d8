"""The device-idle share of the program's ``vo.odom_estimate_pairs`` spans
(``slam.estimate_pairs`` over the consecutive pairs, to its host fetch) in
the traced sub-window: the part of their intervals in which no kernel, copy
or set ran, over their length, in percent."""

from benchmark.metrics import _spans


def read(run):
    return _spans.idle_pct(run, "vo.odom_estimate_pairs")
