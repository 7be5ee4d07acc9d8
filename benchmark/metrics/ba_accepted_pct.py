"""Bundle adjustment's accepted Levenberg-Marquardt steps over the steps it
took, in percent: the counts ``lm_accepted`` and ``lm_steps`` that
``ba.optimize`` and its caller put on the program's ``vo.ba_solve`` spans
in the traced sub-window.  None where the program counts no steps."""

from benchmark.metrics import _spans


def read(run):
    j = _spans.joined(run)
    stage = j and j.stages.get("vo.ba_solve")
    if not stage or not stage.counts.get("lm_steps"):
        return None
    return 100.0 * stage.counts.get("lm_accepted", 0) / stage.counts["lm_steps"]
