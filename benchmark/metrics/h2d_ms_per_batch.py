"""Device time of the host-to-device copies (``Memcpy HtoD`` events) in the
traced sub-window, ms per request (``api._as_images``' copy of the batch)."""


def read(run):
    t = run.trace
    if t is None or not t.count(lambda n: t.kind(n) == "htod"):
        return None
    return 1e3 * t.seconds(lambda n: t.kind(n) == "htod") / t.requests
