"""Prefix sums (``gpu_physics_engine_tpu.ops.scan``): one cumsum each."""

from __future__ import annotations

import torch

__all__ = ["inclusive_scan", "exclusive_scan"]


def inclusive_scan(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive prefix sum along ``dim``, in x's dtype."""
    return torch.cumsum(x, dim=dim, dtype=x.dtype)


def exclusive_scan(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Exclusive prefix sum (the inclusive one shifted, zero first)."""
    inc = inclusive_scan(x, dim)
    return inc - x
