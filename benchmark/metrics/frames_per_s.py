"""Frames whose results were delivered over the whole window, per second:
the frames of every request completed, over the seconds from the window's
start to the end of its last request."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
