"""Position Verlet and the world boundary constraint
(``gpu_physics_engine_tpu.ops.integrate``).

The same equation as the reference's integration pass:

    velocity  = current - previous            (position Verlet)
    accel     = gravity + mouse attraction    (normalize(mouse-pos) * strength)
    predicted = current + velocity + accel * dt^2
    previous  = current
    predicted clamped to [radius, world - radius] per axis (or a circle)

Used by the array pipelines (core/stepper) and, over tile slots, by the
tiled pipeline's plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import SimConfig


def f32(v: float) -> float:
    """A Python float holding exactly the f32 rounding of ``v``, so torch
    computes with the same constant as the JAX package's ``jnp.float32``."""
    return float(np.float32(v))


def sqrt_rn(a: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root.  On the card ``torch.sqrt``
    is already IEEE.  ``torch.sqrt`` of an f32 CPU tensor may take a
    vectorised path that is one ulp off for some inputs, so there the f64
    root of the f32 value is taken and rounded to f32, which is exact (f64
    carries more than 2 x 24 + 2 bits)."""
    if a.is_cuda:
        return torch.sqrt(a)
    return torch.sqrt(a.double()).float()


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
        inv = 1.0 / sqrt_rn(torch.clamp(d2, min=f32(1e-12)))
        nx = torch.where(outside, cx + max_r * dx * inv, nx)
        ny = torch.where(outside, cy + max_r * dy * inv, ny)
        return nx, ny
    if not isinstance(radius, torch.Tensor):
        radius = f32(radius)
    nx = torch.clamp(nx, radius, _minus(config.world_width, radius))
    ny = torch.clamp(ny, radius, _minus(config.world_height, radius))
    return nx, ny


def verlet_integrate(x, y, px, py, radius, active, prm: torch.Tensor,
                     config: SimConfig):
    """One Verlet step with gravity, the mouse attractor and the world
    constraint.  ``prm`` = f32[4] [dt, mouse_x, mouse_y, pressed] on the
    state's device; ``radius`` a tensor or the uniform Python float;
    ``active`` a bool mask.  Returns (x, y, px, py); inactive entries keep
    their values."""
    vel_x = x - px
    vel_y = y - py
    dt, mx, my, pressed = prm[0], prm[1], prm[2], prm[3]
    dxm = mx - x
    dym = my - y
    dist = sqrt_rn(dxm * dxm + dym * dym)
    eps = f32(1e-6)
    inv = torch.where(dist > eps, 1.0 / torch.clamp(dist, min=eps),
                      torch.zeros_like(dist))
    strength = f32(config.mouse_strength) * pressed
    ax = f32(config.gravity[0]) + dxm * inv * strength
    ay = f32(config.gravity[1]) + dym * inv * strength
    dt2 = dt * dt
    nx = x + vel_x + ax * dt2
    ny = y + vel_y + ay * dt2
    nx, ny = apply_world_constraint(nx, ny, radius, config)
    return (torch.where(active, nx, x), torch.where(active, ny, y),
            torch.where(active, x, px), torch.where(active, y, py))
