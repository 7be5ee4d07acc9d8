"""g++ build-and-cache helper for the port's C++ sources.

Counterpart of ``feature_detector_fast_tpu.utils.native_build``: a single
.cpp (the scalar FAST oracle, ``oracle/native_src/fast_oracle.cpp``) is
compiled with g++ on first use into the package's ``_build/`` directory
(the one ``cuda_build`` uses), keyed by the source's hash so an edit
rebuilds, and written atomically (tmp file + ``os.replace``) so concurrent
builds of the same digest are harmless.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def build_shared_lib(src: str) -> str:
    """Compile ``src`` to a cached shared library; returns the .so path.
    Raises subprocess.CalledProcessError if g++ fails."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(src))[0]
    so_path = os.path.join(BUILD_DIR, f"{name}_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so_path)
    return so_path
