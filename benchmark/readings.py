"""The readings a cell's limits are set from: the compared numbers of the
program and of the control, at the cell's own size, seed by seed.

    python3 -m benchmark.readings --workload <cell> --seeds <n> [<n> ...]
        [--requests 3] [--control-seeds <n> ...]

For each seed: the cell's set-up, ``--requests`` requests of the program and
its numbers, then (for the seeds in ``--control-seeds``, by default all)
as many requests with each of the driver's controls in the program's place
and their numbers.  One JSON line per seed and side on stdout.  The
benchmark's own runs never run the control.  Needs the cell's CUDA devices.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def readings(cell, seed: int, requests: int, control: bool, device):
    """[(side, {name: value}, seconds a request)] of one seed: the program,
    then (with ``control``) each of the driver's controls."""
    from . import catalog

    make = catalog.driver(cell.traffic).make
    driver = make(cell.config, cell.traffic, seed, device, cell.limits)
    out = []
    t0 = time.perf_counter()
    out.append(("program", [(i, driver.request()) for i in range(requests)]))
    seconds = {"program": (time.perf_counter() - t0) / requests}
    for name, ctx in (driver.controls().items() if control else ()):
        with ctx():
            out.append((name, [(i, driver.request()) for i in range(requests)]))
    driver.release()
    return [(side, {name: v for name, v, _ in driver.check(kept)[0]}, seconds.get(side))
            for side, kept in out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*")
    ap.add_argument("--requests", type=int, default=3)
    args = ap.parse_args(argv)

    from . import catalog

    spec = catalog.load_json(os.path.join(os.getcwd(), "BENCHMARK.json"))
    cell = catalog.cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    control = set(args.seeds if args.control_seeds is None else args.control_seeds)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for side, numbers, per_request in readings(cell, seed, args.requests, seed in control,
                                                   device):
            print(json.dumps({"workload": cell.name, "seed": seed, "side": side,
                              "numbers": numbers, "s_per_request": per_request,
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
