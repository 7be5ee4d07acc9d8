"""feature_detector_fast_tpu_torch — the PyTorch / CUDA port of the FAST
detector and its front-end, beside the JAX package
``feature_detector_fast_tpu``, which stays the reference it is held against.
It imports neither JAX nor that package.

  * `ops.fast` — dense branchless FAST detection in plain PyTorch
  * `ops.fast_cuda` — the hand-written Hopper FAST kernel (``csrc/fast.cu``)
  * `ops.compact` — packed words to an exact row-major keypoint list
  * `ops.brief_cuda` — every pixel's BRIEF-256 words (``csrc/brief.cu``)
  * `ops.patch_cuda` — per-keypoint windows and patches (``csrc/patch.cu``)
  * `models.brief` — top-K keypoints and BRIEF (sparse, dense, patched,
    steered); ``detect_and_describe(_batch)`` is the front-end step
  * `models.match` — Hamming matching (mutual nearest + ratio test)
  * `models.pyramid` — multi-scale detect + describe
  * `api` — ``detect`` and the batched / device-resident / strongest-K paths
  * `serving` — pipelined batches on a CUDA side stream
  * `parallel` — the multi-device front-end: meshes of explicit devices,
    row-sharded detection of one frame (``csrc/fast.cu``'s row-shard entry
    points), data-parallel batches and the 3-stage detect → describe →
    match pipeline, all driven by one process
  * `models.lie`, `models.twoview`, `models.ba`, `models.posegraph`,
    `models.slam` — the visual-odometry back-end: batched essential RANSAC
    with per-pair Gauss-Newton, scale chaining, loop closures and the pose
    graph, in plain PyTorch on the card (``slam.run_vo_images``)
  * `io.render` — the deterministic synthetic-scene renderer (numpy)

Public API parity with the reference (`src/lib.rs`):

    >>> from feature_detector_fast_tpu_torch import Config, NonmaxMode, detect
    >>> kps = detect(gray_u8_image, Config(threshold=16, count=9,
    ...                                    nonmax=NonmaxMode.OFF))

and the front-end:

    >>> from feature_detector_fast_tpu_torch import detect_and_describe, match
    >>> kps, desc, valid = detect_and_describe(gray_u8_image, 16, 9, k=1000)
"""

from .config import Config, NonmaxMode, Point
from .api import detect, detect_arrays
from .models.brief import Keypoints, detect_and_describe, detect_and_describe_batch
from .models.match import Matches, match
from .models.pyramid import detect_and_describe_multiscale

__all__ = [
    "Config",
    "Keypoints",
    "Matches",
    "NonmaxMode",
    "Point",
    "detect",
    "detect_and_describe",
    "detect_and_describe_batch",
    "detect_and_describe_multiscale",
    "detect_arrays",
    "match",
]

__version__ = "0.1.0"
