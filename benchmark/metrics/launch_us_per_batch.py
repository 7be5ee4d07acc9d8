"""Host microseconds of the program's ``detect.launch`` spans per request
in the traced sub-window: ``api.detect_batch_device``'s enqueue of the FAST
words kernel and the per-frame count."""

from benchmark.metrics import _spans


def read(run):
    v = _spans.host_s_per_request(run, "detect.launch")
    return None if v is None else 1e6 * v
