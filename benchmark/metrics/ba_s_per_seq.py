"""Seconds a sequence of ``refine_with_ba``'s stage timer ``ba_solve`` (the
global bundle-adjustment solves, ``ba.optimize`` and the fetch of its
result; two rounds a sequence), over the window."""


def read(run):
    v = run.spans.get("stage.ba_solve")
    return None if v is None or not run.requests else v / len(run.requests)
