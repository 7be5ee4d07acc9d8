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
from feature_detector_fast_tpu_torch.ops import exp_off, exp_off_cuda
from feature_detector_fast_tpu_torch.ops import fast as fast_ops
from feature_detector_fast_tpu_torch.tools import (
    _common, acceptance, descriptor_bench, exp_off_byteswar, exp_off_floor, exp_off_prepack,
    fast_bench, frontend_bench, resolution_bench, run_slam_demo, scaling_bench, serving_bench,
    sweep, vo_bench)
from feature_detector_fast_tpu_torch.utils.image import load_luma8, save_image

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
TOOLS = ("acceptance", "descriptor_bench", "exp_frontend_stages", "exp_off_byteswar",
         "exp_off_floor", "exp_off_prepack", "exp_r5_f256_mesh", "exp_vo_stages", "fast_bench",
         "frontend_bench", "resolution_bench", "run_slam_demo", "scaling_bench", "serving_bench",
         "sweep", "vo_bench")


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


@pytest.mark.parametrize("tool", [exp_off_floor, exp_off_prepack], ids=lambda t: t.__name__)
def test_exp_off_tools_baseline_needs_the_card(tool, crop):
    """A before/after against another exp_off.cu revision is a device
    measurement: off the card --baseline raises before anything runs."""
    with pytest.raises(ValueError, match="needs the card"):
        next(tool.run(device="cpu", frame=crop, baseline="exp_off.cu"))


@pytest.mark.parametrize("tool", [exp_off_floor, exp_off_prepack], ids=lambda t: t.__name__)
def test_exp_off_tools_main_batch(tool, tmp_path, monkeypatch, capsys, crop):
    """``main`` takes --batch (the frames of the timed batch) and prints one
    JSON record a line."""
    path = str(tmp_path / "frame.png")
    save_image(crop, path)
    monkeypatch.setenv("INPUT_FILE", path)
    assert tool.main(["--device", "cpu", "--rounds", "1", "--batch", "3"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert recs and all(r["device"] == "cpu" for r in recs)
    assert {r["batch"] for r in recs if "batch" in r} == {3}


def test_same_loop_ms_checks_and_interleaves():
    """same_loop_ms checks the baseline's outputs (tensors or tuples) equal
    the current ones, then times baseline, current, current, baseline;
    without a baseline it times the current call once."""
    calls = []

    def fn(name, value=1):
        def call():
            calls.append(name)
            return torch.full((2,), value), torch.zeros(1)
        return call

    cpu = torch.device("cpu")
    ms = _common.same_loop_ms({"current": fn("c"), "baseline": fn("b")}, cpu, rounds=2,
                              repeats=1, what="k")
    assert set(ms) == {"current", "baseline"} and min(ms.values()) > 0
    # the check, then per timing a warm-up call and rounds x repeats calls
    assert calls == ["c", "b"] + ["b"] * 3 + ["c"] * 6 + ["b"] * 3
    calls.clear()
    assert set(_common.same_loop_ms({"current": fn("c")}, cpu, rounds=2, repeats=1,
                                    what="k")) == {"current"}
    assert calls == ["c"] * 3
    with pytest.raises(AssertionError, match="k: current != baseline"):
        _common.same_loop_ms({"current": fn("c"), "baseline": fn("b", 2)}, cpu, rounds=1,
                             repeats=1, what="k")


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
    assert len(checks) == 24 + len(acceptance.RANDOM_SHAPES) + 2 + 3 and checks[0] == "OFF c=9"
    assert recs[0]["keypoints"] == n_keypoints(crop)
    assert all(r["oracle"] for r in recs[:24])
    assert checks[24:24 + len(acceptance.RANDOM_SHAPES)] == [
        f"oracle random {h}x{w}" for h, w in acceptance.RANDOM_SHAPES]
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
    for run in (sweep.run, exp_off_floor.run, acceptance.run, scaling_bench.run, vo_bench.run,
                run_slam_demo.run):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(run())


def test_tools_import_no_jax():
    """The tools and the VO back-end (models lie, twoview, ba, posegraph,
    slam, windowed_ba; parallel ba_sharded; utils metrics, precision; io
    render, warp, kitti, tum) import neither JAX nor the JAX package
    (checked in a fresh interpreter, as the port's own modules are in
    tests/test_torch_api.py)."""
    code = (
        "import sys\n"
        + "".join(f"import feature_detector_fast_tpu_torch.tools.{t}\n" for t in TOOLS)
        + "from feature_detector_fast_tpu_torch.ops import exp_off, exp_off_cuda\n"
        "from feature_detector_fast_tpu_torch.models import (ba, lie, posegraph, slam, twoview,\n"
        "    windowed_ba)\n"
        "from feature_detector_fast_tpu_torch.parallel import ba_sharded\n"
        "from feature_detector_fast_tpu_torch.utils import metrics, precision\n"
        "from feature_detector_fast_tpu_torch.io import kitti, render, tum, warp\n"
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


def test_fast_bench_records(crop):
    """fast_bench on the CPU (the plain version standing in): words and
    dense for each mode on each batch, then the tiles forms, each record
    with its bound and the work it counts from the data; the corners are
    the batch's OFF keypoints (its frames rolled apart)."""
    recs = list(fast_bench.run(device="cpu", rounds=1, repeats=1, frame=crop, batches=(2,),
                               shards=2))
    assert [(r["kernel"], r["mode"], r["at"]) for r in recs] == [
        (f"fdf_fast_{form}{tiles}", mode.value, at)
        for tiles, at in (("", "batch 2"), ("_tiles", "2 shards"))
        for mode in NonmaxMode for form in ("words", "dense")]
    for r in recs:
        assert r["ms"] > 0 and r["device"] == "cpu" and "baseline_ms" not in r
        assert r["share_of_bound"] == r["bound_ms"] / r["ms"]
    assert recs[0]["corners"] == sum(n_keypoints(f) for f in fast_bench.rolled(crop, 2))
    assert recs[-1]["corners"] == n_keypoints(crop)
    assert recs[-1]["pixels"] == (crop.shape[0] - 6) * (crop.shape[1] - 6)
    assert recs[-1]["corners"] < recs[-1]["candidates"] < recs[-1]["pixels"]
    assert recs[-1]["frames"] == 2 and recs[-1]["rows"] == 48
    with pytest.raises(ValueError, match="needs the card"):
        next(fast_bench.run(device="cpu", frame=crop, baseline="fast.cu"))


def test_descriptor_bench_records(crop):
    """descriptor_bench on the CPU (the plain versions standing in): BRIEF
    words per batch and windows per route, each with its bound and share,
    then the describe crossover by k; --baseline needs the card."""
    from feature_detector_fast_tpu_torch.models import brief
    from feature_detector_fast_tpu_torch.ops import brief_cuda, patch_cuda

    before = (dict(brief_cuda.LAUNCHES), dict(patch_cuda.LAUNCHES))
    h, w = crop.shape
    recs = list(descriptor_bench.run(device="cpu", rounds=1, repeats=1, frame=crop,
                                     batches=(1, 2), k=40, batch_k=2, ks=(20, 60),
                                     sizes=((h, w), (h // 2, 2 * w))))
    assert [(r.get("kernel"), r.get("at")) for r in recs[:4]] == [
        ("fdf_brief_words", "batch 1"), ("fdf_brief_words", "batch 2"),
        ("fdf_extract_windows", "2 x 40 keypoints, patched route"),
        ("fdf_extract_windows", "2 x 40 keypoints, steered route")]
    for r in recs[:4]:
        assert r["ms"] > 0 and r["device"] == "cpu" and "baseline_ms" not in r
        assert r["share_of_bound"] == r["bound_ms"] / r["ms"]
    assert recs[1]["bytes"] == 2 * h * w * 33 and recs[1]["bound_by"] == "bytes"
    assert recs[2]["int_ops"] == 2 * 40 * 31 * 31 * 10
    # the crossover's k scale with the pixels of each size
    assert [(r["stage"], r["height"], r["width"], r["k"]) for r in recs[4:]] == [
        ("describe_crossover", h, w, 20), ("describe_crossover", h, w, 60),
        ("describe_crossover", h // 2, 2 * w, round(20 * (h // 2) * 2 / h)),
        ("describe_crossover", h // 2, 2 * w, round(60 * (h // 2) * 2 / h))]
    assert all(r["patched_ms"] > 0 and r["dense_ms"] > 0 for r in recs[4:])
    assert [r["dense_k_min"] for r in recs[4::2]] == [brief._dense_k_min(h, w),
                                                      brief._dense_k_min(h // 2, 2 * w)]
    assert (dict(brief_cuda.LAUNCHES), dict(patch_cuda.LAUNCHES)) == before
    with pytest.raises(ValueError, match="needs the card"):
        next(descriptor_bench.run(device="cpu", frame=crop, baseline="_parent"))


# The work PERF.md states for the main path's (16, 1080, 1920) batch (the
# golden frame rolled 16 ways, fast_bench.rolled) at t=16, n=9: detectable
# pixels, those past the cardinal prefilter, arc-test corners.
BATCH_1080P = (16, 1080, 1920)
WORK_1080P = {"pixels": 16 * 1074 * 1914, "candidates": 2_748_056, "corners": 388_854}
# The golden frame alone (the tiles forms' work over its 8 shards).
WORK_FRAME = {"pixels": 1074 * 1914, "candidates": 171_974, "corners": 24_130}


@pytest.mark.parametrize("mode,words,int_ops,nbytes,by", [
    ("off", True, 669_055_232, 37_324_800, "operations"),
    ("max_threshold", True, 711_051_464, 37_324_800, "operations"),
    ("sum_absolute", True, 697_830_428, 37_324_800, "operations"),
    ("off", False, 669_055_232, 165_888_000, "bytes"),
    ("max_threshold", False, 711_051_464, 165_888_000, "bytes"),
])
def test_fast_bound_counts(mode, words, int_ops, nbytes, by):
    """FAST: 17 ops at every detectable pixel for the cardinal prefilter,
    40 more for the arc test where it passes, and at arc-test corners only
    9 for the nonmax and 99 (MT, n=9) or 65 (SA) for the score; one byte
    in, words or two u16 planes out."""
    b = _common.fast_bound(*BATCH_1080P, mode, 9, WORK_1080P, words=words)
    assert (b["int_ops"], b["bytes"], b["bound_by"]) == (int_ops, nbytes, by)
    assert b["bound_ms"] == pytest.approx(max(int_ops / 16.72704e12, nbytes / 3.35e12) * 1e3)


@pytest.mark.parametrize("count,ops", [(9, 99), (10, 131), (16, 131)])
def test_fast_score_ops(count, ops):
    """The MaxThreshold score's operations: windows of 9 from windows of 3,
    two overlapping 9s beyond 9; SumAbsolute's do not depend on the count."""
    assert _common.fast_score_ops("max_threshold", count) == ops
    assert _common.fast_score_ops("sum_absolute", count) == 65
    assert _common.fast_score_ops("off", count) == 0


def test_fast_work_counts(crop):
    """fast_work counts the detectable pixels, the prefilter's candidates
    (a superset of the arc-test corners) and the corners, frame by frame."""
    imgs = torch.from_numpy(fast_bench.rolled(crop, 2))
    work = _common.fast_work(imgs, 16, 9)
    h, w = crop.shape
    assert work["pixels"] == 2 * (h - 6) * (w - 6)
    assert work["corners"] == sum(n_keypoints(f) for f in imgs.numpy())
    cand = exp_off.prefilter_mask(imgs, 16, 9)
    assert work["candidates"] == int(cand.sum())
    corners = fast_ops.detect_mask(imgs, 16, 9)
    assert not bool((corners & ~cand).any()) and work["corners"] < work["candidates"]
    assert work["warp_rows"] == 2 * h * -(-w // 32)
    padded = torch.nn.functional.pad(cand, (0, -w % 32))
    assert work["busy_warp_rows"] == int(padded.reshape(2, h, -1, 32).any(-1).sum())
    assert work["candidates"] / 32 <= work["busy_warp_rows"] <= work["candidates"]


def test_words_prepacked_bound_counts():
    """The prepacked words kernel computes fdf_fast_words OFF's words, so its
    operations are the OFF words kernel's on the same frames (17 at every
    detectable pixel, 40 more past the prefilter); its bytes are the
    prepacked plane's (per 128-row tile 72 int32 rows of the 1920-wide
    frame) and the words out."""
    plane_bytes = 16 * 9 * 72 * 1920 * 4
    b = _common.words_prepacked_bound(plane_bytes, *BATCH_1080P, 9, WORK_1080P)
    off = _common.fast_bound(*BATCH_1080P, "off", 9, WORK_1080P, words=True)
    assert (b["int_ops"], b["bytes"], b["bound_by"]) == (669_055_232, 79_626_240 + 4_147_200,
                                                         "operations")
    assert b["int_ops"] == off["int_ops"] and b["bound_ms"] == off["bound_ms"]
    assert b["bound_ms"] == pytest.approx(0.0399987, rel=1e-5)


def test_kernel_bound_counts():
    """The other kernels' counts at the main path's shapes, as PERF.md
    states them, and the bound as the larger of the two times."""
    # BRIEF: 264 u16 operations a pixel at two a lane-operation (the kernel
    # compares two pixels with one 32-bit add), so the planes' bytes bound it.
    b = _common.brief_words_bound(*BATCH_1080P)
    assert (b["int_ops"], b["bytes"], b["bound_by"]) == (4_379_443_200, 1_094_860_800, "bytes")
    assert b["bound_ms"] == pytest.approx(0.32682412, rel=1e-6)
    tiles = _common.fast_bound(8, 136, 1920, "max_threshold", 9, WORK_FRAME, words=True,
                               in_bytes=8 * 144 * 1920)
    assert (tiles["int_ops"], tiles["bytes"]) == (44_430_812, 2_211_840 + 8 * 136 * 60 * 4)
    assert _common.floor_bound("load", *BATCH_1080P)["bound_by"] == "bytes"
    assert _common.floor_bound("prefilter", *BATCH_1080P)["int_ops"] == 17 * 16 * 1080 * 1920
    assert _common.swar_pred_bound("pred16", 16384 * 128)["int_ops"] == 97 * 16384 * 128
    assert _common.swar_pred_bound("pred8", 8192 * 128)["int_ops"] == 225 * 8192 * 128
    assert _common.bound(3.35e9, 0) == {"bound_ms": 1.0, "bound_by": "bytes",
                                        "bytes": 3_350_000_000, "int_ops": 0}


def test_window_bounds_count_covered_pixels():
    """Windows and patches read each covered pixel once: overlapping
    keypoints share it, clamped ones stay in the frame."""
    xy = np.array([[[100, 100], [100, 100], [101, 100], [0, 0]]], np.int32)
    covered = _common.window_union_px(xy, 200, 300, lo=17, size=(35, 35), clamp=17)
    assert covered == 35 * 36 + 35 * 35  # two coincide, one overlaps, (0, 0) clamps to (17, 17)
    b = _common.extract_windows_bound(xy, 200, 300)
    assert b["bytes"] == covered + 4 * 8 + 4 * 31 * 31 * 4 and b["bound_by"] == "bytes"
    p = _common.extract_patches_bound(xy, 200, 300)
    assert p["int_ops"] == 0 and p["bytes"] > 4 * 32 * 128 * 4


def test_vo_bench_records():
    """vo_bench at 4 frames of 160 x 120, K=64, on the CPU: one record each
    for host and device-resident frames, with the stage split; the frames
    are the renderer's."""
    from feature_detector_fast_tpu_torch.io import render

    gt, frames = vo_bench.sequence(4, 160, 120, workers=1)
    cfg = vo_bench.render_config(160, 120)
    np.testing.assert_array_equal(frames[2], render.render_frame(gt[2], cfg, frame_id=2))
    recs = list(vo_bench.run(device="cpu", max_keypoints=64, seq=(gt, frames)))
    assert [r["resident"] for r in recs] == [False, True]
    for r in recs:
        assert r["frames"] == 4 and r["poses_finite"] and r["frames_per_sec"] > 0
        assert {"features_s", "frontend_s", "geometry_s", "geo.odom_estimate_pairs_s",
                "geo.pose_graph_s", "ate_pct_of_trajectory"} <= set(r)
        assert r["estimate_pairs_dispatch"] == dict.fromkeys(
            ("kernels", "copies", "launch_calls", "syncs", "device_ms", "wall_ms"))
    cfg = vo_bench.vo_config(64, cfg.camera())
    assert (cfg.max_keypoints, cfg.loop_edge_min_gap, cfg.loop_ratio_mad_max,
            cfg.loop_edge_weight, cfg.ransac_hypotheses) == (512, 48, 0.15, 0.3, 256)


def test_vo_bench_loops_records():
    """vo_bench with loops at 20 frames of 200 x 150, K=300, on the CPU: the
    loop and BA stages in the split, the loop stage's ATE beside the final
    one, and refine_with_ba's dispatch counts (null on the CPU)."""
    gt, frames = vo_bench.sequence(20, 200, 150, workers=1)
    (rec,) = vo_bench.run(device="cpu", max_keypoints=300, seq=(gt, frames), residents=(False,),
                          loops=True)
    assert rec["loops"] and rec["poses_finite"] and rec["frames"] == 20
    assert rec["loops_proposed"] >= 1 and "with loop closure + BA" in rec["metric"]
    assert {"loop_propose_s", "geo.loop_ransac_s", "geo.tracks_host_s",
            "geo.triangulate_gate_host_s", "geo.ba_solve_s", "loop_stage_ate_pct_of_trajectory",
            "loop_links"} <= set(rec)
    assert rec["refine_with_ba_dispatch"] == dict.fromkeys(
        ("kernels", "copies", "launch_calls", "syncs", "device_ms", "wall_ms"))


def test_run_slam_demo_synthetic():
    """The synthetic mode (10 frames, the JAX tool's default): odometry, then
    one loop closure, healthy inlier counts."""
    recs = list(run_slam_demo.run(10, device="cpu"))
    assert [r["stage"] for r in recs] == ["vo_odometry", "vo_loop_closure", "summary"]
    assert all(r["device"] == "cpu" for r in recs)
    assert recs[0]["frames"] == 10 and recs[2]["mean_pair_inliers"] > 100
    assert recs[1]["ate"] <= recs[0]["ate"] * 1.01 and np.isfinite(recs[0]["ate"])


def test_run_slam_demo_images(tmp_path, capsys):
    """``--images DIR`` (tests/test_render_vo.py:245): rendered PNG frames,
    one over-sized (cropped back), no poses: per-pair records, ATE null."""
    from feature_detector_fast_tpu_torch.io import render

    cfg = render.RenderConfig()
    frames = render.render_sequence(render.demo_trajectory(5), cfg)
    for i, f in enumerate(frames):
        if i == 2:
            f = np.pad(f, ((0, 8), (0, 4)), mode="edge")
        save_image(f, str(tmp_path / f"frame_{i:03d}.png"))
    assert run_slam_demo.main(["--images", str(tmp_path), "--max-frames", "5",
                               "--device", "cpu"]) == 0
    records = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    (load,) = [r for r in records if r["stage"] == "load"]
    assert load["format"] == "images" and load["frames"] == 5
    assert load["size"] == [cfg.height, cfg.width]
    assert len([r for r in records if r["stage"] == "pair"]) == 4
    (vo,) = [r for r in records if r["stage"] == "vo_images"]
    assert vo["ate"] is None and vo["mean_pair_inliers"] > 50 and vo["trajectory_frames"] == 5
    empty = tmp_path / "empty"
    empty.mkdir()
    assert run_slam_demo.main(["--images", str(empty), "--device", "cpu"]) == 1


def test_run_slam_demo_sequence(tmp_path):
    """``--sequence PATH`` on a rendered KITTI-layout tree
    (tests/test_render_vo.py:70, 6 frames): detected as KITTI, ATE under 4%
    of the trajectory."""
    from feature_detector_fast_tpu_torch.io import render

    cfg = render.RenderConfig()
    gt = render.demo_trajectory(6)
    seq_dir = tmp_path / "sequences" / "00"
    (seq_dir / "image_0").mkdir(parents=True)
    (tmp_path / "poses").mkdir()
    for i, f in enumerate(render.render_sequence(gt, cfg)):
        save_image(f, str(seq_dir / "image_0" / f"{i:06d}.png"))
    cam = cfg.camera()
    (seq_dir / "calib.txt").write_text(f"P0: {cam.fx} 0 {cam.cx} 0 0 {cam.fy} {cam.cy} 0 0 0 1 0\n")
    (tmp_path / "poses" / "00.txt").write_text(
        "".join(" ".join(str(v) for v in T[:3].reshape(-1)) + "\n" for T in gt))
    recs = list(run_slam_demo.run(mode="sequence", path=str(seq_dir), device="cpu"))
    assert [r["stage"] for r in recs] == ["load", "vo_images"]
    assert recs[0]["format"] == "kitti" and recs[0]["frames"] == 6
    traj = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum()
    assert recs[1]["ate"] < 0.04 * traj
    (bad,) = run_slam_demo.run(mode="sequence", path=str(tmp_path), device="cpu")
    assert bad["error"] == "unrecognized sequence layout"
