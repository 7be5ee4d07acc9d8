"""Host-clock seconds a sequence of the benchmark's span around
``slam.frontend_features`` and ``frontend_matches`` over the window."""


def read(run):
    v = run.spans.get("frontend")
    return None if v is None or not run.requests else v / len(run.requests)
