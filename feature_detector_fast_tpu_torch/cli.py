"""Command-line front-end, mirroring the reference binary (`src/main.rs`).

Counterpart of ``feature_detector_fast_tpu.cli``.  Usage (positional,
left-to-right, like main.rs:21, plus a trailing device option):

    python -m feature_detector_fast_tpu_torch.cli <input> \
        [output (default /tmp/output.png)] [threshold (default 16)] \
        [count (default 9)] [nonmax: off|sum_absolute|max_threshold \
        (default sum_absolute)] [--device cuda|cpu (default cuda)]

Outputs: overlay PNG with red plus markers and a "<x> <y>" per-line text
file next to it (main.rs:4-15, 74-80).  The reference's usage string claims
a max_threshold default but its code defaults to sum_absolute (main.rs:21
vs :43); we follow the code.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

from .api import detect_arrays
from .config import Config, NonmaxMode
from .utils import image as imutil


def write_keypoints(points, filename: str) -> None:
    """Write keypoints as "<x> <y>" lines (reference: main.rs:4-15)."""
    with open(filename, "w") as f:
        for x, y in points:
            f.write(f"{int(x)} {int(y)}\n")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device needs a value (cuda or cpu)")
        device = argv[i + 1]
        del argv[i : i + 2]
    if not argv or argv == ["--help"]:
        print(
            "python -m feature_detector_fast_tpu_torch.cli <input> "
            "[output(default; /tmp/output.png)] [threshold(default: 16)] "
            "[count(default:9)] "
            "[non_maximal_suppression:off|sum_absolute|max_threshold "
            "(default: sum_absolute)] [--device cuda|cpu (default: cuda)]"
        )
        print(" arguments required left to right.")
        return 0

    input_image_file = argv[0]
    output_image_file = argv[1] if len(argv) > 1 else "/tmp/output.png"
    output_txt_file = output_image_file.replace(".png", ".txt")
    threshold = int(argv[2]) if len(argv) > 2 else 16
    count = int(argv[3]) if len(argv) > 3 else 9
    nonmax = NonmaxMode.parse(argv[4]) if len(argv) > 4 else NonmaxMode.SUM_ABSOLUTE

    luma = imutil.load_luma8(input_image_file)
    config = Config(threshold=threshold, count=count, nonmax=nonmax)

    start = time.perf_counter()
    keypoints = detect_arrays(luma, config, device=device)
    elapsed = time.perf_counter() - start
    print(f"Took: {elapsed * 1e3:.3f}ms, found {len(keypoints)} keypoints")

    overlay = imutil.draw_keypoints(luma, keypoints, imutil.RED, size=1)
    imutil.save_image(overlay, output_image_file)
    write_keypoints(keypoints, output_txt_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
