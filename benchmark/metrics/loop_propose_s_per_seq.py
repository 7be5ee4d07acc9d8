"""Host seconds a sequence of the program's ``vo.loop_propose`` spans
(``slam.propose_loop_closures``: the signature gate, the batched matching
of the candidate pairs and their one fetch) in the traced sub-window.
None where the program records no such span."""

from benchmark.metrics import _spans


def read(run):
    return _spans.host_s_per_request(run, "vo.loop_propose")
