"""Multi-device scaling of batched detection: frames/s at 1, 2, 4, ... devices.

Counterpart of the JAX package's ``tools/scaling_bench.py``: for meshes of
n = 1, 2, 4, ... devices, ``parallel.frontend.detect_batch_sharded`` of
4 n copies of a seeded 256 x 512 frame (MaxThreshold, t=16, n=9): after a
warm-up window at each mesh size, the median over ``repeats`` windows of
``rounds`` calls, each timed on the host clock up to a synchronisation of
every device, reported as frames/s and the scaling efficiency
fps_n / (n * fps_1).

Distinct cards are taken where the machine has them (all of them, in
powers of two); the batch starts on the first card, so a round includes
the copies of the other shards to their cards.  With one card the mesh
repeats it up to 4 times, and with ``--device cpu`` the
CPU likewise: each record then says "one card repeated: structural check
only" (or "cpu repeated: ..."), since the shards share one device: there
the n-device run is one launch over 4 n frames.

    python -m feature_detector_fast_tpu_torch.tools.scaling_bench [--device cpu] [--rounds N]
"""

from __future__ import annotations

import sys
import time
from typing import Iterator

import numpy as np

from ..config import NonmaxMode
from ..parallel import frontend, mesh as meshlib
from . import _common

ROUNDS, REPEATS = 50, 5
MAX_REPEATED = 4


def run(*, device="cuda", rounds: int = ROUNDS, repeats: int = REPEATS) -> Iterator[dict]:
    dev, card = _common.start(device)
    cards = meshlib.cuda_devices() if dev.type == "cuda" else [dev]
    distinct = len(cards) > 1
    n_total = len(cards) if distinct else MAX_REPEATED
    note = None if distinct else (
        "one card repeated: structural check only" if dev.type == "cuda"
        else "cpu repeated: structural check only")
    frame = np.random.default_rng(0).integers(0, 256, (256, 512), np.uint8)
    fps1 = None
    n = 1
    while n <= n_total:
        devices = cards[:n] if distinct else [dev] * n
        mesh = meshlib.make_mesh(devices=devices)
        imgs = _common.batch_of(frame, 4 * n, devices[0])

        def window() -> float:
            t0 = time.perf_counter()
            for _ in range(rounds):
                frontend.detect_batch_sharded(imgs, 16, 9, NonmaxMode.MAX_THRESHOLD, mesh=mesh)
            for d in set(devices):
                _common.synchronize(d)
            return time.perf_counter() - t0

        window()  # warm-up at this mesh size
        dt = float(np.median([window() for _ in range(repeats)]))
        fps = rounds * imgs.shape[0] / dt
        fps1 = fps if fps1 is None else fps1
        rec = {"devices": n, "frames_per_s": fps, "scaling_efficiency": fps / (n * fps1),
               "batch": int(imgs.shape[0]), "rounds": rounds, "repeats": repeats,
               "device": card}
        if note:
            rec["note"] = note
        _common.log(f"{n} devices: {fps:.1f} frames/s")
        yield rec
        n *= 2


def main(argv=None) -> int:
    args = _common.parser(__doc__, ROUNDS).parse_args(argv)
    return _common.print_records(run(device=args.device, rounds=args.rounds))


if __name__ == "__main__":
    sys.exit(main())
