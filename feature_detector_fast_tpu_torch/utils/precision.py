"""Full-precision float32 matmuls for the geometry stack.

Counterpart of ``feature_detector_fast_tpu.utils.precision``.  On Hopper,
PyTorch may run float32 matmuls through TF32 (a 10-bit mantissa): the same
trap as the TPU's bf16 passes.  Normal-equation products (J^T J, the Schur
products, E^T E) square condition numbers and then lose them to the short
mantissa.

``tf32_off()`` turns TF32 off for cuBLAS matmuls inside a ``with`` block and
restores the caller's setting on exit; ``matmul_highest`` wraps a function
in it.  Neither changes the setting for the process once every guard has
exited, and a guard holds in every thread while any is open::

    @matmul_highest
    def my_geometry_fn(...): ...

PyTorch has two APIs for the setting: the float32 matmul precision
(``torch.set_float32_matmul_precision``, whose "high" and "medium" are
``torch.backends.cuda.matmul.allow_tf32``) and, from PyTorch 2.9, the
per-backend ``torch.backends.cuda.matmul.fp32_precision``.  A state set
through both raises when it is read, so the guard changes it through the
API the caller's state is in: the precision string where it reads "high"
or "medium", else ``fp32_precision`` where PyTorch has it.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch


class _Guard:
    """The process-wide full-precision state: a depth count of the guards
    open in any thread, and how to restore the caller's setting."""

    def __init__(self):
        self.lock = threading.Lock()
        self.depth = 0
        self.restore = None

    def enter(self) -> None:
        with self.lock:
            if self.depth == 0:
                self.restore = _full_precision()
            self.depth += 1

    def exit(self) -> None:
        with self.lock:
            self.depth -= 1
            if self.depth == 0:
                self.restore()
                self.restore = None


_GUARD = _Guard()


def _full_precision():
    """Turn TF32 off through the API the caller's state is in; returns the
    function that restores that state."""
    matmul = torch.backends.cuda.matmul
    try:
        old = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller set the newer per-backend API
        old = None
    if old not in (None, "highest") or not hasattr(matmul, "fp32_precision"):
        torch.set_float32_matmul_precision("highest")
        return functools.partial(torch.set_float32_matmul_precision, old)
    restore = functools.partial(setattr, matmul, "fp32_precision", matmul.fp32_precision)
    matmul.fp32_precision = "ieee"
    return restore


@contextlib.contextmanager
def tf32_off():
    """Float32 cuBLAS matmuls at full precision inside; the caller's
    setting, read back through either API, after.  The setting is the
    process's, so guards open in several threads share one state: the first
    entry saves the caller's setting, the last exit restores it."""
    _GUARD.enter()
    try:
        yield
    finally:
        _GUARD.exit()


def matmul_highest(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with tf32_off():
            return fn(*args, **kwargs)

    return wrapper
