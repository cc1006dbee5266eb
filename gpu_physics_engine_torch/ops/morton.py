"""2D Morton (Z-order) codes (``gpu_physics_engine_tpu.ops.morton``).

torch has few operations on uint32, so a code is held in an int64 tensor
whose value is the u32 code (0 .. 0xFFFFFFFF).  Inputs are reduced to
their low 16 bits first, as the JAX package's u32 cast and mask do: the
coordinate -1 becomes 0xFFFF, and the cell (-1, -1) encodes to
0xFFFFFFFF, the UNUSED sentinel.  int64 codes sort as unsigned keys.
"""

from __future__ import annotations

import torch

__all__ = ["morton_encode", "morton_decode", "split_by_bits",
           "unsplit_by_bits"]


def split_by_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the lower 16 bits of each element to even bit positions."""
    x = v.to(torch.int64) & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def unsplit_by_bits(v: torch.Tensor) -> torch.Tensor:
    """Inverse of split_by_bits: compact even bit positions to the low 16."""
    x = v.to(torch.int64) & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def morton_encode(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """int64 holding the u32 Z-order code of integer cell coords."""
    return split_by_bits(cx) | (split_by_bits(cy) << 1)


def morton_decode(code: torch.Tensor):
    """(cx, cy) int64 cell coords (0 .. 0xFFFF) of a u32 Z-order code."""
    c = code.to(torch.int64) & 0xFFFFFFFF
    return unsplit_by_bits(c), unsplit_by_bits(c >> 1)
