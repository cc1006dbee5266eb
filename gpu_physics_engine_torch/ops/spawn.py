"""Interactive particle spawning (``gpu_physics_engine_tpu.ops.spawn``).

Capacity is static, so a spawn writes ``count`` rows at ``num_active`` and
bumps the counter; nothing is reallocated.  The ring geometry is the
reference's: particle i lands at mouse + polar(angle ~ U[0, tau),
dist ~ U[10, 50 + 1.5 i]), with an integer radius ~ U{1, 2, 3}.  The
random numbers come from a CPU torch.Generator, so they are not the JAX
package's; given the same burst, ``add_particles`` gives the same state.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.state import ParticleState

_RING_MIN_DIST = 10.0
_RING_MAX_DIST_BASE = 50.0
_RING_MAX_DIST_STEP = 1.5


def ring_burst(generator: torch.Generator, mouse_x: float, mouse_y: float,
               count: int, max_spawn_radius: int = 3):
    """(x, y, radii), f32 [count] CPU tensors: positions on a widening ring
    around the cursor (particle i at distance U[10, 50 + 1.5 i]), radii
    uniform integers in {1..max_spawn_radius}."""
    f32 = torch.float32
    i = torch.arange(count, dtype=f32)
    angle = torch.rand(count, generator=generator) * float(
        np.float32(2.0 * math.pi))
    max_dist = _RING_MAX_DIST_BASE + i * _RING_MAX_DIST_STEP
    dist = _RING_MIN_DIST + torch.rand(count, generator=generator) * (
        max_dist - _RING_MIN_DIST)
    sx = float(np.float32(mouse_x)) + dist * torch.cos(angle)
    sy = float(np.float32(mouse_y)) + dist * torch.sin(angle)
    radii = torch.randint(1, max_spawn_radius + 1, (count,),
                          generator=generator).to(f32)
    return sx, sy, radii


def burst_colors(generator: torch.Generator, count: int) -> torch.Tensor:
    """f32 [count, 4] RGBA: channels U[0.3, 1.0), alpha 1."""
    c = 0.3 + torch.rand((count, 4), generator=generator) * 0.7
    c[:, 3] = 1.0
    return c


def add_particles(config: SimConfig, state: ParticleState, sx, sy, radii,
                  colors: Optional[torch.Tensor] = None) -> ParticleState:
    """Append the burst (sx, sy, radii[, colors]) at ``num_active``, at
    rest.  A burst that would pass max_particles is refused whole and the
    state comes back unchanged.  Reads num_active from the device once."""
    count = sx.shape[0]
    start = int(state.num_active)
    if start + count > config.max_particles:
        return state
    rows = slice(start, start + count)

    def upd(dst, src):
        out = dst.clone()
        out[rows] = src.to(device=dst.device, dtype=dst.dtype)
        return out

    color = state.color
    if color.shape[-1] and colors is not None:
        color = upd(color, colors)
    radii_max = radii.max().to(state.device)
    return state.replace(
        x=upd(state.x, sx), y=upd(state.y, sy),
        px=upd(state.px, sx), py=upd(state.py, sy),
        radius=upd(state.radius, radii), color=color,
        num_active=state.num_active + count,
        max_radius=torch.maximum(state.max_radius, radii_max))
