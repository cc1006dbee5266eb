"""Host rasterizer (``gpu_physics_engine_tpu.render.rasterizer``): ``splat``
blends particles as soft-edged circles into a host framebuffer in draw
order; ``draw_axis_lines`` draws 1 px axis-aligned lines (the grid).

The C++ source is the port's own copy, ``render/native/rasterizer.cpp``,
built with g++ at first use (ops/_native.py) with the JAX package's
Makefile flags and OpenMP, so that the two builds round alike on one
machine.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from gpu_physics_engine_torch.ops import _native

SOURCE = _native.PKG / "render" / "native" / "rasterizer.cpp"
CXX_FLAGS = _native.CXX_FLAGS + ("-fopenmp",)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded rasterizer library, built first if no current build
    exists."""
    lib = _native.load(SOURCE, CXX_FLAGS)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.splat_particles.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p, f32p,
        ctypes.c_int64]
    lib.splat_particles.restype = None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.draw_lines.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p, u8p,
        ctypes.c_int64]
    lib.draw_lines.restype = None
    return lib


def _check_frame(frame: np.ndarray) -> None:
    if not (frame.ndim == 3 and frame.shape[2] == 3
            and frame.dtype == np.float32 and frame.flags.c_contiguous):
        raise ValueError("frame must be a C-ordered float32 [H, W, 3] array")


def splat(frame: np.ndarray, sx, sy, sradius, rgb) -> np.ndarray:
    """Blend particles into ``frame`` (H, W, 3 float32, C order; mutated
    and returned).  sx, sy: pixel-space centres (y down); sradius: pixel
    radius; rgb [N, 3]."""
    _check_frame(frame)
    h, w = frame.shape[:2]
    sx = np.ascontiguousarray(sx, np.float32)
    sy = np.ascontiguousarray(sy, np.float32)
    sradius = np.ascontiguousarray(sradius, np.float32)
    rgb = np.ascontiguousarray(rgb, np.float32)
    n = sx.shape[0]
    if n:
        library().splat_particles(frame, w, h, sx, sy, sradius, rgb, n)
    return frame


def draw_axis_lines(frame: np.ndarray, a, b, rgb, horizontal) -> np.ndarray:
    """Draw 1 px axis-aligned lines into ``frame`` (H, W, 3 float32, C
    order; mutated and returned): line k runs from a[k] to b[k] in pixel
    coordinates, along x where horizontal[k], else along y."""
    _check_frame(frame)
    h, w = frame.shape[:2]
    a = np.ascontiguousarray(a, np.float32).reshape(-1, 2)
    b = np.ascontiguousarray(b, np.float32).reshape(-1, 2)
    rgb = np.ascontiguousarray(rgb, np.float32).reshape(-1, 3)
    horizontal = np.ascontiguousarray(horizontal, np.uint8)
    n = a.shape[0]
    if not (b.shape[0] == rgb.shape[0] == horizontal.shape[0] == n):
        raise ValueError("a, b, rgb and horizontal must have one row a line")
    if n:
        library().draw_lines(frame, w, h, a, b, rgb, horizontal, n)
    return frame
