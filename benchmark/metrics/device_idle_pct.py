"""The share of the traced sub-window in which no kernel, copy or set ran
on the device (one minus the union of their intervals over the window's
host-clock length), in percent."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
