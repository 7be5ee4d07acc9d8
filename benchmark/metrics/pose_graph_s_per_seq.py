"""Seconds a sequence of ``run_vo_matches``' stage timer ``pose_graph``
(``posegraph.optimize``), over the window."""


def read(run):
    v = run.spans.get("stage.pose_graph")
    return None if v is None or not run.requests else v / len(run.requests)
