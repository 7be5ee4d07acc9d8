"""Build-and-load helper for the port's CUDA kernels.

Counterpart of ``feature_detector_fast_tpu.utils.native_build``: each
``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, on first use, and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Libraries are cached in the package's ``_build/`` directory keyed by the
hash of the source and the flags, so an edit rebuilds; the write is atomic
(tmp file + ``os.replace``), so concurrent builds are harmless.  A failed
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills in the log
)


def nvcc_path() -> str:
    """``nvcc`` of the CUDA toolkit PyTorch finds (``CUDA_HOME``,
    ``CUDA_PATH``, ``nvcc`` on ``PATH``, or the default install)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` to a cached shared library; returns its path.

    The compiler's output (including ``-Xptxas -v``) is kept beside the
    library as ``<name>.log``.  Raises RuntimeError if nvcc fails."""
    src = os.path.join(SRC_DIR, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    name = os.path.splitext(source)[0]
    so_path = os.path.join(BUILD_DIR, f"{name}_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.tmp{os.getpid()}"
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, src, "-o", tmp],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        with open(so_path[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, so_path)
    return so_path


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``, once per process."""
    return ctypes.CDLL(build(source))


def build_log(source: str) -> str:
    """The compiler output kept by :func:`build` for ``csrc/<source>``."""
    with open(build(source)[:-3] + ".log") as f:
        return f.read()
