"""The device's allocated peak over the window (``max_memory_allocated``
after a reset at its start), in GiB."""


def read(run):
    return None if run.window_peak_bytes is None else run.window_peak_bytes / 2**30
