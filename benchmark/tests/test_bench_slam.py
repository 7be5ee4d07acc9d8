"""The SLAM cell (``vo-tum-vga-slam.loops-ba``) on the CPU at a tiny size:
its comparison shown to catch each planted fault and the control, and its
per-layer metrics read from a recorded span set.

The tiny size closes loops (16 frames of a 160 x 120 circuit of radius 0.5,
K = 128, proposal gap 8 at 30 matches, one pool sequence); there the
program reads other numbers than at the cell's size, so a fault is held to
the rule its limit was set by (PERF.md section 2): its number reads at
least 3x the program's on the same seed (for a cost ratio, its excess over
1), or infinite where the fault leaves a round out."""

import functools
import time
from typing import Dict, NamedTuple

import pytest
import torch

from benchmark import catalog, core
from benchmark.yardstick.trace import Trace

from .conftest import spec

SLAM = "vo-tum-vga-slam.loops-ba"
CPU = torch.device("cpu")
SEED = 2**31 + 7


def tiny_slam() -> catalog.Cell:
    cell = catalog.cell(spec(), SLAM)
    cell.config["frames"] = 16
    cell.config["scene"].update(width=160, height=120, fx=130.0, fy=130.0, radius=0.5)
    cell.config["vo"].update(max_keypoints=128)
    cell.config["loops"].update(gap=8, min_matches=30)
    cell.traffic.update(pool=1, trace_requests=1)
    return cell


@pytest.fixture(scope="module")
def sides():
    """Each side's compared numbers at the tiny size, one request each: the
    program, the control and every fault."""
    from benchmark.readings import readings

    return {side: numbers for side, numbers, _ in readings(tiny_slam(), SEED, 1, True, CPU)}


def _excess(name, v):
    return v - 1.0 if name.endswith("cost_ratio") else v


@pytest.mark.parametrize("side, number", [
    ("nonstrict", "frontend_mismatch"), ("ba_skipped", "ba_cost_ratio"),
    ("ba_skipped", "ba_pose_gap"), ("ba_half_iters", "ba_cost_ratio"),
    ("ba_half_iters", "ba_pose_gap"), ("ba_bf16", "ba_cost_ratio"), ("ba_bf16", "ba_pose_gap"),
    ("pose_turned", "loop_graph_link_gap"), ("loops_dropped", "loop_pairs_per_edge"),
    ("loops_dropped", "ba_cost_ratio"), ("rotation_avg_skipped", "rotation_avg_gap_rad"),
    ("rotation_avg_skipped", "ba_gate_mismatch_pct")])
def test_fault_reads_past_the_program(sides, side, number):
    program, fault = sides["program"], sides[side]
    assert program["frontend_mismatch"] == program["match_mismatch"] == 0
    assert program["loop_mismatch"] == 0
    got, base = _excess(number, fault[number]), _excess(number, program[number])
    assert got == float("inf") or (base >= 0 and got >= 3 * base and got > 0), (program, fault)


@pytest.mark.parametrize("side", ["program", "nonstrict", "ba_skipped", "ba_half_iters",
                                  "ba_bf16", "pose_turned", "loops_dropped",
                                  "rotation_avg_skipped"])
def test_cell_limits_at_the_tiny_size(sides, side):
    """Under the cell's own limits the program reads correct and the control
    and each fault the comparison catches read past a limit.  (At the tiny
    size one loop edge turned by a degree moves the graph by rounding, and
    TF32 is caught by nothing at any size: PERF.md.)"""
    limits = tiny_slam().limits
    over = {k: v for k, v in sides[side].items() if v > limits[k]}
    assert (not over) == (side == "program"), (side, over)


def test_skipped_ba_is_not_correct(monkeypatch):
    """A whole run with ``refine_with_ba`` returning its input poses reads
    ``correct`` false: no round of bundle adjustment to compare."""
    from feature_detector_fast_tpu_torch.models import slam

    skipped = functools.wraps(slam.refine_with_ba)(lambda poses, *a, **k: poses)
    monkeypatch.setattr(slam, "refine_with_ba", skipped)
    line = core.measure(tiny_slam(), seed=SEED, seconds=0.3, trace=False, device=CPU,
                        t_start=time.perf_counter())
    assert line["correct"] is False
    assert line["checks"]["ba_cost_ratio"]["value"] == 1e300


@pytest.mark.parametrize("module, name, dtype", [
    ("posegraph", "SOLVE_DTYPE", torch.float32), ("posegraph", "SOLVE_DTYPE", None),
    ("ba", "GLOBAL_SOLVE_DTYPE", torch.float32), ("ba", "GLOBAL_SOLVE_DTYPE", None)])
def test_a_program_solving_below_the_config_cannot_run_it(monkeypatch, module, name, dtype):
    """A program that solves the loop pose graph or global BA in float32, or
    names no solve dtype, is refused at set-up, before any rendering: it
    cannot run the configuration's ``solve_dtype``."""
    import importlib

    mod = importlib.import_module(f"feature_detector_fast_tpu_torch.models.{module}")
    if dtype is None:
        monkeypatch.delattr(mod, name)
    else:
        monkeypatch.setattr(mod, name, dtype)
    cell = tiny_slam()
    with pytest.raises(ValueError, match=name):
        catalog.driver(cell.traffic).make(cell.config, cell.traffic, SEED, CPU, cell.limits)


@pytest.mark.cuda
def test_cell_size_program_and_precision_faults(cuda_device):
    """On the card at the cell's own size, each pool sequence once: the
    program reads within every limit; the solves in bfloat16 and with half
    their LM steps read past ``ba_cost_ratio``'s, one loop edge turned by a
    degree past ``loop_graph_link_gap``'s."""
    cell = catalog.cell(spec(), SLAM)
    driver = catalog.driver(cell.traffic).make(cell.config, cell.traffic, SEED, cuda_device,
                                               cell.limits)
    n = len(driver.pool)
    kept = {"program": [(i, driver.request()) for i in range(n)]}
    for side in ("ba_bf16", "ba_half_iters", "loop_turned"):
        with driver.controls()[side]():
            kept[side] = [(i, driver.request()) for i in range(n)]
    driver.release()
    got = {side: {k: v for k, v, _ in driver.check(answers)[0]} for side, answers in kept.items()}
    assert all(v <= cell.limits[k] for k, v in got["program"].items()), got
    for side in ("ba_bf16", "ba_half_iters"):
        assert got[side]["ba_cost_ratio"] > cell.limits["ba_cost_ratio"], got
    assert got["loop_turned"]["loop_graph_link_gap"] > cell.limits["loop_graph_link_gap"], got


# -- the per-layer metrics


class Rec(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int = -1
    counts: Dict[str, int] = {}


class _Recorded(list):
    """A span buffer as ``tracing.spans()`` returns it."""

    dropped = 0


def _run(spans):
    trace = Trace(2, 128, 1e-6, [("k", 100, 200), ("k", 500, 600)], [("bench.request", 0, 1000)])
    return core.Run(catalog.cell(spec(), SLAM), None, 0.0, [(0.0, 1.0), (1.0, 2.0)], 128, 2.0,
                    None, spans, trace=trace)


#: The cell's own readers, and the pose graph's, which read the loop graph
#: on this cell.
NEW = ("ba_s_per_seq", "ba_idle_pct", "ba_accepted_pct", "loop_propose_s_per_seq",
       "pose_graph_s_per_seq", "pose_graph_replay_pct")


def test_new_metrics_read_a_recorded_span_set(monkeypatch):
    from benchmark.metrics import _spans

    records = [Rec(0, "vo.loop_propose", 0, 50),
               Rec(1, "vo.pose_graph", 50, 150, counts={"calls": 1, "steps": 40}),
               Rec(2, "vo.ba_solve", 150, 350, counts={"solves": 1, "lm_steps": 20,
                                                       "cg_steps": 800, "lm_accepted": 15}),
               Rec(3, "vo.ba_solve", 450, 650, counts={"solves": 1, "lm_steps": 20,
                                                       "cg_steps": 800, "lm_accepted": 5})]
    monkeypatch.setattr(_spans, "_records", lambda: _Recorded(records))
    run = _run({"stage.ba_solve": 3.0, "stage.pose_graph": 2.0})
    got = {m: catalog.reader(m).read(run) for m in NEW}
    assert got["ba_s_per_seq"] == 1.5 and got["pose_graph_s_per_seq"] == 1.0
    assert got["ba_accepted_pct"] == 50.0 and got["pose_graph_replay_pct"] == 0.0
    assert got["loop_propose_s_per_seq"] == 50 / 1e9 / 2
    # device busy [100, 200] and [500, 600]: of the solves' 400 ns, 150 busy
    assert got["ba_idle_pct"] == 62.5


def test_new_metrics_read_nothing_without_spans(monkeypatch):
    """At the parent (no ``vo.loop_propose`` span, no BA counts) and where
    the program records no spans, the span readers give None and none
    raises."""
    from benchmark.metrics import _spans

    parent = [Rec(0, "vo.ba_solve", 150, 350), Rec(1, "vo.pose_graph", 0, 100)]
    monkeypatch.setattr(_spans, "_records", lambda: _Recorded(parent))
    run = _run({})
    for m in ("ba_accepted_pct", "loop_propose_s_per_seq", "pose_graph_replay_pct",
              "ba_s_per_seq", "pose_graph_s_per_seq"):
        assert catalog.reader(m).read(run) is None, m
    monkeypatch.setattr(_spans, "_records", None)
    run = _run({})
    for m in NEW:
        assert catalog.reader(m).read(run) is None, m
