"""``frames_per_s`` of a cell that reports it per layer, where its runs spread
too widely for an end-to-end bound: the same reading, the frames of every
request completed over the seconds from the window's start to the end of its
last request."""

from benchmark.metrics.frames_per_s import read  # noqa: F401
