"""Public configuration / result types for the FAST detector.

Counterpart of ``feature_detector_fast_tpu.config``, mirroring the
reference's `src/lib.rs` API surface (`Point` lib.rs:17-20,
`NonMaximalSuppression` lib.rs:26-36, `Config` lib.rs:40-52).  The config
is frozen and hashable; its fields are validated once here so every entry
point (and the CUDA kernel's launch arguments) can trust them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple


class Point(NamedTuple):
    """A feature point at an image position (reference: lib.rs:17-20)."""

    x: int
    y: int


class NonmaxMode(enum.Enum):
    """Non-maximal suppression modes (reference: lib.rs:26-36).

    - ``OFF``: all features satisfying the consecutive-arc threshold are kept.
    - ``MAX_THRESHOLD``: score = maximum t for which the feature would still
      be a feature; OpenCV's score.
    - ``SUM_ABSOLUTE``: score = max over the bright/dark sets of the summed
      absolute threshold excess (paper eq. 3); the authors' recommendation.
    """

    OFF = "off"
    MAX_THRESHOLD = "max_threshold"
    SUM_ABSOLUTE = "sum_absolute"

    @classmethod
    def parse(cls, name: str) -> "NonmaxMode":
        """Parse a CLI-style mode name (reference: main.rs:41-50)."""
        try:
            return cls(name)
        except ValueError:
            raise ValueError(
                f"unknown non maximal mode {name!r}, "
                "support: off, sum_absolute, max_threshold"
            ) from None


# Minimum consecutive count supported; below 9 the cardinal prefilter logic
# does not hold (reference asserts the same, fast_simd.rs:302-305).
MIN_COUNT = 9
MAX_COUNT = 16


@dataclasses.dataclass(frozen=True)
class Config:
    """Configuration for the FAST feature detector (reference: lib.rs:40-52).

    Attributes:
      threshold: circle pixels must differ from the center by strictly more
        than this to count toward the consecutive run (u8 range, 0..=255).
      count: minimum number of consecutive qualifying circle pixels,
        9 <= count <= 16.
      nonmax: non-maximal suppression mode.
    """

    threshold: int = 16
    count: int = 9
    nonmax: NonmaxMode = NonmaxMode.OFF

    def __post_init__(self) -> None:
        # Canonicalize to exact Python ints, rejecting lossy values like
        # 16.9 or '16': a silently-truncated float would detect with
        # different semantics than configured.
        for field in ("threshold", "count"):
            v = getattr(self, field)
            # bool is an int subclass: int(True) == True would pass the
            # round-trip check and turn threshold=True into 1 silently.
            if isinstance(v, (bool, str)):
                raise TypeError(f"{field} must be an integer, got {v!r}")
            try:
                iv = int(v)
            except (TypeError, ValueError, OverflowError):
                # OverflowError: int(float('inf'))
                raise TypeError(f"{field} must be an integer, got {v!r}")
            if iv != v:
                raise TypeError(f"{field} must be an integer, got {v!r}")
            object.__setattr__(self, field, iv)
        if not (0 <= self.threshold <= 255):
            raise ValueError(f"threshold must be in 0..=255, got {self.threshold}")
        if not (MIN_COUNT <= self.count <= MAX_COUNT):
            raise ValueError(
                f"count must be in {MIN_COUNT}..={MAX_COUNT}, got {self.count}"
            )
        if not isinstance(self.nonmax, NonmaxMode):
            raise TypeError(f"nonmax must be a NonmaxMode, got {self.nonmax!r}")

    def detect(self, image, *, device="cuda"):
        """Method-style detection entry point (reference: lib.rs:56-58)."""
        from .api import detect

        return detect(image, self, device=device)
