"""The comparison that decides ``correct``, shown to fail.

Each test drives a whole run (set-up, window, comparison) on the CPU at a
tiny size with the timed path broken underneath, and sees ``correct`` come
out false: once for each fault a cell can have.  One chip, so no exchange
between chips exists to leave out.  Then the controls: the reference with
the configuration's guarantee broken, in the program's place."""

import time

import numpy as np
import pytest
import torch

from benchmark import core

from .conftest import tiny

CPU = torch.device("cpu")


def run(cell):
    return core.measure(cell, seed=2**31 + 7, seconds=0.3, trace=False, device=CPU,
                        t_start=time.perf_counter())


def _drop_last_keypoint(lists):
    lists = list(lists)
    lists[-1] = lists[-1][:-1]
    return lists


# -- detection: an answer altered where it is produced, half the batch left out


def test_host_answer_altered(monkeypatch):
    from feature_detector_fast_tpu_torch import api

    real = api.detect_batch_arrays
    monkeypatch.setattr(api, "detect_batch_arrays",
                        lambda *a, **k: _drop_last_keypoint(real(*a, **k)))
    line = run(tiny("fast-1080p.host-b16"))
    assert line["correct"] is False
    assert line["checks"]["keypoints_mismatched"]["value"] > 0


def test_host_half_the_batch_left_out(monkeypatch):
    from feature_detector_fast_tpu_torch import api

    real = api.detect_batch_arrays

    def half(images, *a, **k):
        out = real(images[: len(images) // 2], *a, **k)
        return out + out

    monkeypatch.setattr(api, "detect_batch_arrays", half)
    line = run(tiny("fast-1080p.host-b16"))
    assert line["correct"] is False


def test_resident_answer_altered(monkeypatch):
    from feature_detector_fast_tpu_torch import api

    real = api.detect_batch_device

    def altered(*a, **k):
        words, n = real(*a, **k)
        words = words.clone()
        words[-1].view(-1)[torch.nonzero(words[-1].view(-1))[0]] = 0
        return words, n

    monkeypatch.setattr(api, "detect_batch_device", altered)
    line = run(tiny("fast-1080p.resident-b16"))
    assert line["correct"] is False
    assert line["checks"]["keypoints_mismatched"]["value"] > 0


def test_resident_half_the_batch_left_out(monkeypatch):
    from feature_detector_fast_tpu_torch import api

    real = api.detect_batch_device

    def half(images, *a, **k):
        words, n = real(images[: len(images) // 2], *a, **k)
        return torch.cat([words, words]), torch.cat([n, n])

    monkeypatch.setattr(api, "detect_batch_device", half)
    line = run(tiny("fast-1080p.resident-b16"))
    assert line["correct"] is False
    assert line["checks"]["counts_mismatched"]["value"] > 0


# -- VO: an answer altered where it is produced, half the batch left out, a
# step that returns its state unchanged

VO = "vo-tum-vga.odometry"


def test_vo_match_altered(monkeypatch):
    from feature_detector_fast_tpu_torch.models import slam

    real = slam.frontend_matches

    def altered(*a, **k):
        pairs = real(*a, **k)
        pa, pb, ok, idx = pairs[0]
        idx = idx.copy()
        slot = int(np.nonzero(ok)[0][0])
        idx[slot] = (idx[slot] + 1) % len(idx)
        return [(pa, pb, ok, idx)] + pairs[1:]

    monkeypatch.setattr(slam, "frontend_matches", altered)
    line = run(tiny(VO))
    assert line["correct"] is False
    assert line["checks"]["match_mismatch"]["value"] > 0


def test_vo_half_the_frames_left_out(monkeypatch):
    """The front-end describes half the sequence and repeats it."""
    from feature_detector_fast_tpu_torch.models import slam

    real = slam.frontend_features

    def half(frames, *a, **k):
        feats = real(frames[: len(frames) // 2], *a, **k)
        return tuple(torch.cat([f, f]) for f in feats)

    monkeypatch.setattr(slam, "frontend_features", half)
    line = run(tiny(VO))
    assert line["correct"] is False
    assert line["checks"]["frontend_mismatch"]["value"] > 0


def test_vo_frontend_state_unchanged(monkeypatch):
    """The front-end's step returns its output state as it started: every
    slot empty (no keypoint, no descriptor)."""
    from feature_detector_fast_tpu_torch.models import slam

    real = slam.frontend_features

    def unchanged(*a, **k):
        return tuple(torch.zeros_like(f) for f in real(*a, **k))

    monkeypatch.setattr(slam, "frontend_features", unchanged)
    line = run(tiny(VO))
    assert line["correct"] is False
    assert line["checks"]["frontend_mismatch"]["value"] > 0


@pytest.mark.parametrize("fault, number", [("scales_unchanged", "link_scale_gap"),
                                           ("pose_turned", "link_pose_gap")])
def test_vo_geometry_fault(fault, number):
    """The scale chain returned as it started (every pair at scale 1), and
    the pose graph's answer altered where it is produced (one pose turned
    by a degree), each fail the geometry."""
    from benchmark import catalog

    cell = tiny(VO)
    driver = catalog.driver(cell.traffic).make(cell.config, cell.traffic, 2**31 + 7, CPU,
                                              cell.limits)
    with driver.controls()[fault]():
        kept = [(0, driver.request())]
    numbers, failed = driver.check(kept)
    values = {k: v for k, v, _ in numbers}
    assert failed == 1 and values[number] > cell.limits[number], values


# -- the controls


@pytest.mark.parametrize("name", ["fast-1080p.host-b16", "fast-1080p.resident-b16"])
def test_detection_control_is_not_correct(name):
    """The plain detector with >= in place of OpenCV's strict > fails."""
    from benchmark.readings import readings

    sides = {side: numbers for side, numbers, _ in readings(tiny(name), 2**31 + 3, 2, True, CPU)}
    assert sides["program"]["keypoints_mismatched"] == 0
    assert sides["nonstrict"]["keypoints_mismatched"] > 0


def test_vo_control_is_not_correct():
    """The front-end with FAST's strict threshold broken, in the program's
    place, fails the exact front-end number."""
    from benchmark.readings import readings

    cell = tiny(VO)
    sides = {side: numbers for side, numbers, _ in readings(cell, 2**31 + 3, 1, True, CPU)}
    assert all(v <= cell.limits[k] for k, v in sides["program"].items()), sides["program"]
    assert sides["nonstrict"]["frontend_mismatch"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fast-1080p.host-b16", "fast-1080p.resident-b16", VO])
@pytest.mark.parametrize("seed", [2**31 + 3, 2**31 + 5, 2**31 + 11])
def test_controls_at_the_cells_size(cuda_device, name, seed):
    """On the card at the cell's own size: the program reads its limit or
    less in every compared number, the control reads more in one."""
    from benchmark import catalog
    from benchmark.readings import readings

    from .conftest import spec

    cell = catalog.cell(spec(), name)
    sides = {side: numbers for side, numbers, _ in readings(cell, seed, 3, True, cuda_device)}
    assert all(v <= cell.limits[k] for k, v in sides["program"].items()), sides["program"]
    assert any(v > cell.limits[k] for k, v in sides["nonstrict"].items()), sides["nonstrict"]
