"""95th percentile (nearest rank) of every request's latency in the window,
from its issue to its results in hand, in ms (closed loop: a request is due
when it is issued)."""

from benchmark import core


def read(run):
    lat = run.latencies_s
    return 1e3 * core.quantile(lat, 0.95) if lat else None
