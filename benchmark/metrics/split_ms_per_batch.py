"""Host milliseconds of the program's ``detect.split`` spans per request in
the traced sub-window: ``compact.split_frames``' per-frame counts, its two
fetches and the split into per-frame lists."""

from benchmark.metrics import _spans


def read(run):
    v = _spans.host_s_per_request(run, "detect.split")
    return None if v is None else 1e3 * v
