"""Tile-map view of the tiled engine (``gpu_physics_engine_tpu.render.tilemap``).

The tiled engine's storage is already a spatial histogram, so a frame can
be aggregated on the engine's device, per tile the occupant count and the
mean velocity magnitude, and only the [TY, TX] maps cross to the host.
The host applies the reference's velocity colormap
(particle_drawer.wgsl:39-67) with a density-driven alpha.

``tile_stats`` is plain PyTorch over ``[CAP, TY, TX]``, as the JAX
package's is jnp.  Its rounding follows the port's rules so that the map
is the same on the CPU and on the card: the square root through
``sqrt_rn``, the CAP sum as a left fold in slot order (one add a slot, the
same order on both devices), and the mean a division of two tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gpu_physics_engine_torch.ops.integrate import sqrt_rn
from gpu_physics_engine_torch.ops.tiled import TileState
from gpu_physics_engine_torch.render.colormap import (
    COLOR_HIGH, COLOR_LOW, COLOR_MID, MAX_VELOCITY, smoothstep)


def tile_stats(state: TileState) -> Tuple[torch.Tensor, torch.Tensor]:
    """([TY, TX] int32 occupant count, [TY, TX] f32 mean |v| over the
    occupants), on the state's device."""
    occ = state.occupied()
    count = torch.sum(occ, dim=0, dtype=torch.int32)
    vx = state.x - state.px
    vy = state.y - state.py
    speed = torch.where(occ, sqrt_rn(vx * vx + vy * vy),
                        torch.zeros((), dtype=torch.float32,
                                    device=state.device))
    total = speed[0]
    for k in range(1, speed.shape[0]):
        total = total + speed[k]
    return count, total / torch.clamp(count, min=1).to(torch.float32)


def render_tilemap(state: TileState, scale: int = 1,
                   cap_reference: Optional[int] = None) -> np.ndarray:
    """[TY*scale, TX*scale, 3] uint8 frame (the border ring dropped):
    velocity colormap weighted by tile density (vacant tiles are black,
    like the reference clear color).

    cap_reference sets the count treated as "full" for the brightness
    ramp; defaults to the state's slot capacity."""
    count, mean_v = tile_stats(state)
    count = count[1:-1, 1:-1].cpu().numpy()      # drop the border ring
    mean_v = mean_v[1:-1, 1:-1].cpu().numpy()
    cap = cap_reference or state.dims[0]

    t = np.clip(mean_v / MAX_VELOCITY, 0.0, 1.0)
    s1 = smoothstep(0.0, 0.5, t)[..., None]
    s2 = smoothstep(0.5, 1.0, t)[..., None]
    color = COLOR_LOW * (1.0 - s1) + COLOR_MID * s1
    color = color * (1.0 - s2) + COLOR_HIGH * s2
    density = np.clip(count / float(cap), 0.0, 1.0)[..., None]
    frame = (color * density * 255.0).astype(np.uint8)
    frame = frame[::-1]  # world y-up -> image row 0 at the top
    if scale > 1:
        frame = np.repeat(np.repeat(frame, scale, axis=0), scale, axis=1)
    return frame
