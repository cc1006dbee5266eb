"""World boundary constraint (``gpu_physics_engine_tpu.ops.integrate``)."""

from __future__ import annotations

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import SimConfig


def f32(v: float) -> float:
    """A Python float holding exactly the f32 rounding of ``v``, so torch
    computes with the same constant as the JAX package's ``jnp.float32``."""
    return float(np.float32(v))


def _minus(a: float, radius):
    """f32(a) - radius, rounded in f32 for a tensor or a float radius."""
    if isinstance(radius, torch.Tensor):
        return f32(a) - radius
    return float(np.float32(a) - np.float32(radius))


def apply_world_constraint(nx: torch.Tensor, ny: torch.Tensor, radius,
                           config: SimConfig):
    """Box clamp to [r, world - r] per axis, or projection of escapees onto
    the largest inscribed circle (config.world_shape == "circle").
    ``radius`` is a tensor broadcastable to ``nx`` or a Python float."""
    if config.world_shape == "circle":
        cx = f32(config.world_width / 2.0)
        cy = f32(config.world_height / 2.0)
        max_r = _minus(min(config.world_width, config.world_height) / 2.0,
                       radius)
        dx = nx - cx
        dy = ny - cy
        d2 = dx * dx + dy * dy
        outside = d2 > max_r * max_r
        inv = 1.0 / torch.sqrt(torch.clamp(d2, min=f32(1e-12)))
        nx = torch.where(outside, cx + max_r * dx * inv, nx)
        ny = torch.where(outside, cy + max_r * dy * inv, ny)
        return nx, ny
    if not isinstance(radius, torch.Tensor):
        radius = f32(radius)
    nx = torch.clamp(nx, radius, _minus(config.world_width, radius))
    ny = torch.clamp(ny, radius, _minus(config.world_height, radius))
    return nx, ny
