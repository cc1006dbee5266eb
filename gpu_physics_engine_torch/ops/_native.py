"""g++ builds of the port's host C++ (``render/native/rasterizer.cpp``,
``ops/native/tiler.cpp``).

Each source is built at first use into ``gpu_physics_engine_torch/_build/``
(listed in .gitignore) with the JAX package's Makefile flags; the
library's name carries a hash of the source and the flags.  A failed
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

from gpu_physics_engine_torch.ops._cuda import _PKG as PKG
from gpu_physics_engine_torch.ops._cuda import BUILD_DIR

CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


def library_path(source: Path, flags: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def load(source: Path, flags: Sequence[str] = CXX_FLAGS) -> ctypes.CDLL:
    """The library built from ``source``, built first if no current build
    exists (atomically: no process sees a partial .so)."""
    so = library_path(source, flags)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            tmp = os.path.join(work, "lib.so")
            out = subprocess.run(["g++", *flags, "-o", tmp, str(source)],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed ({out.returncode}) building "
                                   f"{source}:\n{out.stderr}")
            os.replace(tmp, so)
    return ctypes.CDLL(str(so))
