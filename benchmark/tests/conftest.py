"""Shared fixtures of the benchmark's tests: the cells of ``BENCHMARK.json``
cut to sizes a CPU test holds, and the card where a test needs one."""

import json
import os

import pytest
import torch

from benchmark import catalog

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def spec() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny(name: str) -> catalog.Cell:
    """A cell of BENCHMARK.json at a CPU test's size."""
    cell = catalog.cell(spec(), name)
    if cell.traffic["driver"].startswith("detect"):
        cell.config.update(height=64, width=160)
        cell.traffic.update(batches=2, trace_requests=3)
    else:
        cell.config["frames"] = 12
        cell.config["scene"].update(width=160, height=120, fx=130.0, fy=130.0)
        cell.config["vo"].update(max_keypoints=128)
        cell.traffic.update(trace_requests=1)
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
