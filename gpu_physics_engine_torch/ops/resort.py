"""Periodic Morton-order locality resort (``gpu_physics_engine_tpu.ops.resort``).

Every sort interval the particle SoA is reordered by the Morton code of
each particle's home cell, so particles near in space are near in memory
and the broad phase's gathers and scatters stay local.  Inactive slots
keep the UNUSED code, so they sort to the tail and the active prefix stays
contiguous.  Every per-particle field moves, colors included.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gpu_physics_engine_torch.core.config import UNUSED_CELL_ID
from gpu_physics_engine_torch.core.state import ParticleState
from gpu_physics_engine_torch.ops import morton
from gpu_physics_engine_torch.ops.grid import home_cells
from gpu_physics_engine_torch.ops.sort import argsort_u32


def home_cell_codes(x, y, active, cell_size) -> torch.Tensor:
    """u32 Morton code (int64) of each particle's home cell; UNUSED for
    inactive slots."""
    cx, cy = home_cells(x, y, cell_size)
    return torch.where(active, morton.morton_encode(cx, cy), UNUSED_CELL_ID)


def morton_resort(state: ParticleState, cell_size, sort_impl: str = "lax"
                  ) -> Tuple[ParticleState, torch.Tensor]:
    """(the state reordered by home-cell Morton code, the permutation i32)."""
    codes = home_cell_codes(state.x, state.y, state.active_mask(), cell_size)
    _, perm = argsort_u32(codes, impl=sort_impl)
    idx = perm.to(torch.int64)
    moved = {f: getattr(state, f)[idx]
             for f in ("x", "y", "px", "py", "radius")}
    color = state.color[idx] if state.color.shape[-1] else state.color
    return state.replace(**moved, color=color,
                         steps_since_sort=torch.zeros_like(
                             state.steps_since_sort)), perm
