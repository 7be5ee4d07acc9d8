"""Kernels the device ran in the traced sub-window, per frame."""


def read(run):
    t = run.trace
    if t is None or not t.frames or not t.kernels:
        return None
    return t.kernels / t.frames
