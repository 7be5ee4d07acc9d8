"""The port's tools (``feature_detector_fast_tpu_torch/tools``) on the CPU.

Each tool's ``run(device="cpu")`` at tiny sizes and one or two rounds: its
records' keys, and its keypoint counts against ``detect_arrays``.  Times
from these runs are host times of the plain PyTorch versions and are only
checked to be positive.  The tools' kernels and their exactness against
the JAX package are tests/test_torch_exp_off.py's; on the card,
``chip_smoke.py`` runs every tool.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from feature_detector_fast_tpu_torch import api
from feature_detector_fast_tpu_torch.config import Config, NonmaxMode
from feature_detector_fast_tpu_torch.ops import exp_off_cuda
from feature_detector_fast_tpu_torch.tools import (
    _common, acceptance, exp_off_byteswar, exp_off_floor, exp_off_prepack, frontend_bench,
    resolution_bench, scaling_bench, serving_bench, sweep)
from feature_detector_fast_tpu_torch.utils.image import load_luma8, save_image

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
TOOLS = ("acceptance", "exp_off_byteswar", "exp_off_floor", "exp_off_prepack",
         "frontend_bench", "resolution_bench", "scaling_bench", "serving_bench", "sweep")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker (see tests/test_torch_fast.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def crop():
    """A 96 x 160 crop of the 1080p golden frame: 247 / 42 / 72 keypoints
    (OFF / MT / SA, t=16, n=9), 45 of SA's inside the BRIEF border."""
    frame = load_luma8(os.path.join(REPO, "media", "golden_1080p.png"))
    return np.ascontiguousarray(frame[500:596, 900:1060])


def n_keypoints(frame, threshold=16, count=9, mode=NonmaxMode.OFF) -> int:
    return len(api.detect_arrays(frame, Config(threshold, count, mode), device="cpu"))


def test_build_1080p_frame_matches_bench(tmp_path, monkeypatch, crop):
    """The port's copy of bench.build_1080p_frame gives the same frame, with
    and without the INPUT_FILE override."""
    monkeypatch.delenv("INPUT_FILE", raising=False)
    frame = _common.build_1080p_frame()
    assert frame.shape == (1080, 1920) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, bench.build_1080p_frame())
    path = str(tmp_path / "frame.png")
    save_image(crop, path)
    monkeypatch.setenv("INPUT_FILE", path)
    np.testing.assert_array_equal(_common.build_1080p_frame(), crop)
    np.testing.assert_array_equal(bench.build_1080p_frame(), crop)


def test_exp_off_floor_records(crop):
    recs = list(exp_off_floor.run(device="cpu", rounds=1, repeats=1, batch=2, frame=crop))
    stages = [r["stage"] for r in recs]
    assert stages == ["xor-floor", "pad-floor", "load", "triple", "prefilter", "production",
                      "shares_of_production"]
    for r in recs[:-1]:
        assert r["ms_per_frame"] > 0 and r["device"] == "cpu" and r["batch"] == 2
    assert recs[-1]["load_share"] > 0 and "arc_test_share" in recs[-1]


def test_exp_off_prepack_records(crop):
    before = dict(exp_off_cuda.LAUNCHES)
    recs = list(exp_off_prepack.run(device="cpu", rounds=1, repeats=1, batch=2, frame=crop))
    assert recs[0]["stage"] == "check" and recs[0]["bit_exact"] is True
    assert recs[0]["plane_bytes_per_frame"] == 72 * 256 * 4  # one tile, a 256-wide plane
    assert [r["stage"] for r in recs[1:]] == ["production", "prepacked", "prepack",
                                              "prepacked_kernel", "delta"]
    assert all(r["ms_per_frame"] > 0 for r in recs[1:-1])
    assert exp_off_cuda.LAUNCHES == before  # the CPU path launches nothing


def test_exp_off_byteswar_records():
    recs = list(exp_off_byteswar.run(device="cpu", rounds=1, repeats=1, rows=8, grid=4))
    assert [r["stage"] for r in recs] == ["seq16", "seq8", "ratio"]
    assert recs[0]["pixels"] == recs[1]["pixels"] == 4 * 8 * 128 * 2
    assert recs[0]["plane_shape"] == [32, 128] and recs[1]["plane_shape"] == [16, 128]
    assert recs[2]["byte_over_16bit_time"] > 0


def test_acceptance_ok_on_a_crop(crop):
    recs = list(acceptance.run(device="cpu", frame=crop))
    last = recs[-1]
    assert last == {"ok": True, "configs": 24, "failures": [], "device": "cpu"}
    checks = [r["check"] for r in recs[:-1]]
    assert len(checks) == 24 + 2 + 3 and checks[0] == "OFF c=9"
    assert recs[0]["keypoints"] == n_keypoints(crop)
    brief_recs = [r for r in recs if r.get("check", "").startswith("BRIEF")]
    assert all(r["valid_slots"] > 0 for r in brief_recs)


def test_acceptance_main_writes_artifact(tmp_path, monkeypatch, capsys, crop):
    """``main`` with --artifact: the record names the device, the last stdout
    line is the summary, the exit code 0."""
    path = str(tmp_path / "frame.png")
    save_image(crop, path)
    monkeypatch.setenv("INPUT_FILE", path)
    artifact = tmp_path / "acceptance.json"
    assert acceptance.main(["--device", "cpu", "--artifact", str(artifact)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "configs": 24, "failures": [], "device": "cpu"}
    rec = json.loads(artifact.read_text())
    assert rec["ok"] and rec["device"] == "cpu" and rec["configs_run"] == 24
    assert len(rec["configs_passed"]) == 24 and rec["frame"] == path
    assert rec["goldens"]["OFF"] == {"got": 309, "want": 309}
    assert rec["package_tree"] == acceptance.package_tree()


def test_acceptance_package_tree_is_git_tree(tmp_path):
    """package_tree gives the id git gives the same directory in a commit:
    nested directories, an executable file, names that sort differently as
    trees; build outputs and caches left out."""
    if shutil.which("git") is None:
        pytest.skip("git is not installed")
    pkg = tmp_path / "pkg"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "ops-x").mkdir()
    (pkg / "a.py").write_text("a = 1\n")
    (pkg / "ops" / "b.cu").write_text("// b\n")
    (pkg / "ops-x" / "c").write_bytes(bytes(range(256)))
    (pkg / "run.sh").write_text("#!/bin/sh\n")
    (pkg / "run.sh").chmod(0o755)

    def git(*args):
        return subprocess.run(["git", *args], cwd=tmp_path, check=True, capture_output=True,
                              text=True).stdout.strip()

    git("init", "-q")
    git("add", "pkg")
    want = git("rev-parse", git("write-tree") + ":pkg")
    (pkg / "_build").mkdir()
    (pkg / "_build" / "x.so").write_bytes(b"\0")
    (pkg / "__pycache__").mkdir()
    (pkg / "__pycache__" / "a.pyc").write_bytes(b"\0")
    assert acceptance.package_tree(str(pkg)) == want


def test_resolution_bench_counts(crop):
    res = [("tiny", 160, 96), ("wide", 300, 100)]
    recs = list(resolution_bench.run(NonmaxMode.OFF, device="cpu", rounds=1, repeats=1,
                                     frame=crop, resolutions=res, resident_px=3 * 160 * 96))
    assert [r["resolution"] for r in recs] == ["tiny", "wide"]
    for r, (_, w, h) in zip(recs, res):
        assert r["keypoints"] == n_keypoints(_common.tiled(crop, h, w))
        assert r["batch"] == max(4, round(3 * 160 * 96 / (h * w)))
        assert set(r) >= {"width", "height", "mode", "ms_per_frame", "frames_per_sec",
                          "megapixels_per_sec", "device"}
        assert r["mode"] == "off"


def test_sweep_counts(crop):
    recs = list(sweep.run(device="cpu", rounds=1, repeats=1, frame=crop, counts=(9, 12),
                          thresholds=(16, 32)))
    assert [(r["count"], r["threshold"]) for r in recs] == [(9, 16), (9, 32), (12, 16), (12, 32)]
    for r in recs:
        assert r["nonmax"] == "sum_absolute"
        assert r["keypoints"] == n_keypoints(crop, r["threshold"], r["count"],
                                             NonmaxMode.SUM_ABSOLUTE)


def test_serving_bench_bit_exact(crop):
    recs = list(serving_bench.run(device="cpu", rounds=2, batch=2, frame=crop))
    assert recs[0]["stage"] == "pcie_link" and "note" in recs[0]
    assert [r["config"] for r in recs[1:]] == ["off", "max_threshold", "sum_absolute"]
    for r in recs[1:]:
        assert r["bit_exact"] is True
        assert r["keypoints"] == n_keypoints(crop, mode=NonmaxMode(r["config"]))
        for depth in (1, 2, 4):
            assert r[f"depth{depth}_ms_per_frame"] > 0
        assert "cap" not in r


def test_frontend_bench_records(crop):
    recs = list(frontend_bench.run(k=40, device="cpu", rounds=1, repeats=1, frame=crop,
                                   resolutions=[("tiny", 160, 96)], resident_px=3 * 160 * 96))
    assert [r["stage"] for r in recs] == ["detect+describe", "detect+describe+match",
                                          "oriented-detect+describe",
                                          "oriented-detect+describe+match"]
    assert all(r["batch"] == 4 and r["k"] == 40 and r["ms_per_frame"] > 0 for r in recs)


def test_scaling_bench_structure():
    recs = list(scaling_bench.run(device="cpu", rounds=1, repeats=1))
    assert [r["devices"] for r in recs] == [1, 2, 4]
    assert [r["batch"] for r in recs] == [4, 8, 16]
    assert recs[0]["scaling_efficiency"] == 1.0
    assert all(r["note"] == "cpu repeated: structural check only" for r in recs)


def test_tools_default_to_cuda():
    """Without CUDA a tool's default device raises: no silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device works here")
    for run in (sweep.run, exp_off_floor.run, acceptance.run, scaling_bench.run):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(run())


def test_tools_import_no_jax():
    """The tools import neither JAX nor the JAX package (checked in a fresh
    interpreter, as the port's own modules are in tests/test_torch_api.py)."""
    code = (
        "import sys\n"
        + "".join(f"import feature_detector_fast_tpu_torch.tools.{t}\n" for t in TOOLS)
        + "from feature_detector_fast_tpu_torch.ops import exp_off, exp_off_cuda\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'feature_detector_fast_tpu', 'bench')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_loop_ms_folds_every_round():
    """loop_ms calls fn once to warm up and rounds x repeats times more,
    folding each output (tensors, tuples of them) into its accumulator."""
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(3, dtype=torch.uint8), (torch.tensor([True, False]),)

    ms = _common.loop_ms(fn, torch.device("cpu"), rounds=3, repeats=2)
    assert ms > 0 and len(calls) == 1 + 3 * 2
    assert _common.loop_ms(fn, torch.device("cpu"), rounds=3, repeats=2, folded=False) > 0
    assert len(calls) == 2 * (1 + 3 * 2)
    acc = torch.zeros((), dtype=torch.int64)
    _common.fold(acc, fn())
    assert int(acc) == 4
