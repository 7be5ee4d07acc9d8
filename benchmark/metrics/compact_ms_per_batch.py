"""Device time of every kernel that is not the FAST kernel (compaction,
decode, the count: ``ops/compact``) in the traced sub-window, ms per
request; copies and sets are not counted."""

KERNEL = "fast_kernel"


def read(run):
    t = run.trace
    if t is None:
        return None
    other = lambda n: t.kind(n) == "kernel" and KERNEL not in n  # noqa: E731
    if not t.count(other):
        return None
    return 1e3 * t.seconds(other) / t.requests
