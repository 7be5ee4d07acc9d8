"""The device-idle share of the program's ``vo.ba_solve`` spans (the global
bundle-adjustment solves and the fetch of their results) in the traced
sub-window: the part of their intervals in which no kernel, copy or set
ran, over their length, in percent."""

from benchmark.metrics import _spans


def read(run):
    return _spans.idle_pct(run, "vo.ba_solve")
