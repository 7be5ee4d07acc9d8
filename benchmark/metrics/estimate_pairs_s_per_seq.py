"""Seconds a sequence of ``run_vo_matches``' stage timer
``odom_estimate_pairs`` (``slam.estimate_pairs`` over the consecutive
pairs), over the window."""


def read(run):
    v = run.spans.get("stage.odom_estimate_pairs")
    return None if v is None or not run.requests else v / len(run.requests)
