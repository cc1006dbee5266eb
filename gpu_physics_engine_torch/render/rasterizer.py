"""Point-splat rasterizer (``gpu_physics_engine_tpu.render.rasterizer``,
``splat`` only): particles as soft-edged circles blended into a host
framebuffer in draw order.

The C++ source is the port's own copy, ``render/native/rasterizer.cpp``.
It is built with g++ at first use into ``gpu_physics_engine_torch/_build/``
(listed in .gitignore) with the JAX package's Makefile flags, so that the
two builds round alike on one machine; the library's name carries a hash
of the source and flags.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "render" / "native" / "rasterizer.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-fopenmp")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librasterizer_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded splat library, built first if no current build exists."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            tmp = os.path.join(work, "lib.so")
            out = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed ({out.returncode}) building "
                                   f"{SOURCE}:\n{out.stderr}")
            os.replace(tmp, so)  # atomic: no process sees a partial .so
    lib = ctypes.CDLL(str(so))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.splat_particles.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p, f32p,
        ctypes.c_int64]
    lib.splat_particles.restype = None
    return lib


def splat(frame: np.ndarray, sx, sy, sradius, rgb) -> np.ndarray:
    """Blend particles into ``frame`` (H, W, 3 float32, C order; mutated
    and returned).  sx, sy: pixel-space centres (y down); sradius: pixel
    radius; rgb [N, 3]."""
    if not (frame.ndim == 3 and frame.shape[2] == 3
            and frame.dtype == np.float32 and frame.flags.c_contiguous):
        raise ValueError("frame must be a C-ordered float32 [H, W, 3] array")
    h, w = frame.shape[:2]
    sx = np.ascontiguousarray(sx, np.float32)
    sy = np.ascontiguousarray(sy, np.float32)
    sradius = np.ascontiguousarray(sradius, np.float32)
    rgb = np.ascontiguousarray(rgb, np.float32)
    n = sx.shape[0]
    if n:
        library().splat_particles(frame, w, h, sx, sy, sradius, rgb, n)
    return frame
