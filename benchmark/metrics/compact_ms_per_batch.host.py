"""``compact_ms_per_batch`` of the host-batch cell: the same reading, the
device time of every kernel that is not the FAST kernel (count,
``words_to_points``, split) in the traced sub-window, ms per request."""

from benchmark.metrics.compact_ms_per_batch import read  # noqa: F401
