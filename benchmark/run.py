"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell, its
configuration, traffic, driver, limits and metrics are found by name (see
``catalog``).  Needs as many CUDA devices as the cell asks for; without
them it exits with code 2 and prints no result.  The last line of stdout is
the result as one JSON object; the numbers compared against their limits
are the last lines of stderr.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
#: Build and kernel caches at fixed paths inside the checkout.
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
#: Host work in few threads, for steady runs.
THREADS = 4
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = str(THREADS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import catalog, core

    spec = catalog.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = catalog.cell(spec, args.workload)

    import torch

    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        core.log(f"needs {cell.chips} CUDA device(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = core.measure(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          device=device, t_start=T_START)
    found = core.forbidden_modules()
    if found:
        core.log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    core.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
