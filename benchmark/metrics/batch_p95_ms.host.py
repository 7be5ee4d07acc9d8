"""``batch_p95_ms`` of a cell that reports it per layer, where its runs spread
too widely for an end-to-end bound: the same reading, the nearest-rank 95th
percentile of every request's latency in the window, in ms."""

from benchmark.metrics.batch_p95_ms import read  # noqa: F401
