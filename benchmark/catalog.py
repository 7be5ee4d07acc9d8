"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them.

Every part is a file of its own, so a later change adds a configuration, a
traffic mix, a driver, a check or a metric as a new file:
  * ``configs/<config>.json``: the deployment, as it is run;
  * ``traffic/<traffic>.json``: the mix's parameters, among them the
    ``driver`` that runs it;
  * ``drivers/<driver>.py``: ``make(config, traffic, seed, device)`` returns
    the driver of one run (see ``core``);
  * ``checks/<cell>.json``: the limit of each number that decides
    ``correct``;
  * ``metrics/<metric>.py``: ``read(run)`` returns the metric's value, or
    None where the run holds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    chips: int
    #: The metrics this cell reports, end-to-end and per-layer.
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(spec: dict, name: str, root: str = HERE) -> Cell:
    """The cell ``name`` of the parsed ``BENCHMARK.json`` ``spec``."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    config = load_json(os.path.join(root, "configs", f"{w['config']}.json"))
    traffic = load_json(os.path.join(root, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(root, "checks", f"{name}.json"))
    return Cell(name, config, traffic, limits, int(w["chips"]),
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


def _module(kind: str, name: str, root: str):
    """``<root>/<kind>/<name>.py`` as a module; a name may hold dots."""
    path = os.path.join(root, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    qual = f"{__package__}.{kind}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(qual, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(traffic: dict, root: str = HERE):
    return _module("drivers", traffic["driver"], root)


def reader(metric: str, root: str = HERE):
    return _module("metrics", metric, root)
