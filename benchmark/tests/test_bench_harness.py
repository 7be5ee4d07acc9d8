"""The harness end to end on the CPU at tiny sizes: every cell's driver
against the plain reference, the result line's keys, a cell and a metric
added as new files only, and the import guard.  The measured command itself
needs a card; these drive ``core.measure`` with ``device="cpu"``."""

import ast
import io
import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import catalog, core

from .conftest import REPO, spec, tiny

CELLS = [w["name"] for w in spec()["workloads"]]
CPU = torch.device("cpu")


def measure(cell, trace=False, seconds=0.3, root=catalog.HERE):
    return core.measure(cell, seed=2**31 + 99, seconds=seconds, trace=trace, device=CPU,
                        t_start=time.perf_counter(), root=root)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_rehearsal(name, trace):
    cell = tiny(name)
    result = measure(cell, trace=trace)
    out = io.StringIO()
    with redirect_stdout(out):
        core.print_result(result)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = cell.per_layer if trace else cell.end_to_end
    # On the CPU no device metric has anything to read.
    host = {m["name"] for m in want if m["source"] != "device_trace"}
    assert host <= set(line["metrics"]), (host, line["metrics"])
    assert all(m["unit"] == next(w["unit"] for w in want if w["name"] == k)
               for k, m in line["metrics"].items())
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"device_ops", "idle_gaps"} == set(line["breakdown"])
        assert "busy_s" in line["device"] and "window_s" in line["device"]


@pytest.mark.parametrize("name,trace,fps_name", [
    ("fast-1080p.resident-b16", False, "frames_per_s"),
    ("fast-1080p.host-b16", True, "frames_per_s.host"),
])
def test_setup_and_window_metrics(name, trace, fps_name):
    cell = tiny(name)
    line = measure(cell, trace=trace, seconds=0.5)
    m = line["metrics"]
    if not trace:
        assert m["setup_s"]["value"] > 0
    fps = m[fps_name]["value"]
    assert fps > 0
    # frames/s covers every request of the window: attempted x batch frames.
    assert line["attempted"] * cell.traffic["batch"] / fps >= 0.5


def test_every_cell_reports_what_its_layers_move():
    """Each cell reports set-up and one more end-to-end metric, and a
    per-layer metric of a cell moves an end-to-end metric of that cell;
    every metric has a reader."""
    s = spec()
    for name in CELLS:
        cell = catalog.cell(s, name)
        ends = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in ends and len(ends) >= 2, (name, ends)
        assert cell.per_layer, name
        for m in cell.per_layer:
            assert m["moves"] in ends, (name, m["name"], m["moves"])
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(catalog.reader(m["name"]).read), m["name"]


def test_quantile_is_nearest_rank():
    assert core.quantile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 0.95) == 10
    assert core.quantile(list(range(1, 101)), 0.95) == 95
    assert core.quantile([3.0], 0.95) == 3.0


def test_new_cell_and_metric_from_new_files_only(tmp_path):
    """A traffic mix, a configuration, a check file and a metric reader
    added as files, beside the existing ones, are found by name."""
    root = tmp_path / "benchmark"
    shutil.copytree(catalog.HERE, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (root / "configs" / "fast-720p.json").write_text(json.dumps(
        {"width": 1280, "height": 720, "threshold": 20, "count": 12, "nonmax": "sum_absolute"}))
    (root / "traffic" / "host-b4.json").write_text(json.dumps(
        {"driver": "detect_host", "batch": 4, "pool": 4, "batches": 2, "trace_requests": 2}))
    (root / "checks" / "fast-720p.host-b4.json").write_text(json.dumps(
        {"keypoints_mismatched": 0}))
    (root / "metrics" / "requests_in_window.py").write_text(
        "def read(run):\n    return len(run.requests)\n")
    s = spec()
    s["configs"].append({"name": "fast-720p", "source": "x", "file": "benchmark/configs/x.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "fast-720p.host-b4", "config": "fast-720p",
                           "traffic": "host-b4", "chips": 1, "why": "x"})
    s["end_to_end"].append({"name": "requests_in_window", "unit": "requests",
                            "better": "higher", "bound": 0.1, "source": "host_clock",
                            "workloads": ["fast-720p.host-b4"]})
    cell = catalog.cell(s, "fast-720p.host-b4", root=str(root))
    assert cell.config["count"] == 12 and cell.traffic["batch"] == 4
    cell.config.update(height=48, width=96)
    line = measure(cell, root=str(root))
    assert line["correct"] is True
    assert line["metrics"]["requests_in_window"]["value"] == line["attempted"]
    assert "batch_p95_ms" not in line["metrics"]  # not listed for this cell


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(sub=""):
    base = os.path.join(catalog.HERE, sub)
    for d, _, files in os.walk(base):
        if "tests" in d.split(os.sep):
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_in_the_benchmarks_sources():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in core.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for sub in ("reference", "yardstick", "data"):
        for path in _sources(sub):
            for name in _imports(path):
                assert name.split(".")[0] != "feature_detector_fast_tpu_torch", (path, name)


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_no_jax(name):
    """Everything a run loads, in a fresh interpreter: the cell's driver and
    the program's path through it (at a tiny size on the CPU), its metric
    readers and its comparison."""
    code = f"""
import sys, time, torch
from benchmark import core
from benchmark.tests.conftest import tiny
cell = tiny({name!r})
for trace in (False, True):
    core.measure(cell, seed=5, seconds=0.2, trace=trace, device=torch.device("cpu"),
                 t_start=time.perf_counter())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not loaded & set(core.FORBIDDEN), loaded & set(core.FORBIDDEN)
    assert "feature_detector_fast_tpu_torch" in loaded


def test_the_command_fails_without_a_card_or_the_program(tmp_path):
    """Without CUDA the command prints no result and exits non-zero; in a
    directory that holds only BENCHMARK.json and the benchmark, too."""
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copytree(catalog.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
