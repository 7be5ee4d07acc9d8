"""Host milliseconds of the program's ``detect.h2d`` spans per request in
the traced sub-window: what ``api._as_images``' pageable copy of the batch
to the device costs the host (``h2d_ms_per_batch`` is its device time)."""

from benchmark.metrics import _spans


def read(run):
    v = _spans.host_s_per_request(run, "detect.h2d")
    return None if v is None else 1e3 * v
