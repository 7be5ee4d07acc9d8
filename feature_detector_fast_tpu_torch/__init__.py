"""feature_detector_fast_tpu_torch — the PyTorch / CUDA port of the FAST
detector, beside the JAX package ``feature_detector_fast_tpu``, which stays
the reference it is held against.  It imports neither JAX nor that package.

  * `ops.fast` — dense branchless FAST detection in plain PyTorch
  * `ops.fast_cuda` — the hand-written Hopper kernel (``csrc/fast.cu``)
  * `ops.compact` — packed words to an exact row-major keypoint list
  * `api` — ``detect`` and the batched / device-resident / strongest-K paths
  * `serving` — pipelined batches on a CUDA side stream

Public API parity with the reference (`src/lib.rs`):

    >>> from feature_detector_fast_tpu_torch import Config, NonmaxMode, detect
    >>> kps = detect(gray_u8_image, Config(threshold=16, count=9,
    ...                                    nonmax=NonmaxMode.OFF))
"""

from .config import Config, NonmaxMode, Point
from .api import detect, detect_arrays

__all__ = [
    "Config",
    "NonmaxMode",
    "Point",
    "detect",
    "detect_arrays",
]

__version__ = "0.1.0"
