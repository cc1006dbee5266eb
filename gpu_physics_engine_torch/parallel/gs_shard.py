"""The reference-exact Gauss-Seidel frame on a slab mesh, a bitwise
prototype (``gpu_physics_engine_tpu.parallel.gs_shard``).

Within one color the cells are particle-disjoint, so a color pass has no
order across cells, only across colors: a slab can run any color pass on
its own if its ghost rows hold the positions the previous colors left.
Each slab is extended by E = 2 ghost tile rows a side (a boundary cell's
members reach one row past it, and their membership one row further).
The ghost cells' sweeps are redundant work: the neighbour sweeps the
same cells from the same values, and the f32 results are the same bits.
A frame exchanges the frozen membership fields once (x, y, radius, pid
and occupancy: 2 rows x cap x TX each way) and then x and y before
colors 2, 3 and 4: four exchanges a frame (``bytes_per_frame``).

The frame is the plain tensor solve of ops/gs_tiled on the extended slab
(``memberships`` and the colors at the slab's global row origin), and
equals ``gs_tiled.gs_solve`` on the whole grid bit for bit.  As in the
JAX package it is not wired into ShardedTiledEngine: the Gauss-Seidel
solve needs storage == home every step, which the sharded claim sweep
restores only at its cadence.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.ops import gs_tiled
from gpu_physics_engine_torch.ops.tiled import TileState
from gpu_physics_engine_torch.parallel.mesh import Mesh
from gpu_physics_engine_torch.parallel.tiled_shard import (
    sharded_tile_geometry, with_counters)

_I32 = torch.int32
_E = 2  # ghost rows a side


def bytes_per_frame(config: SimConfig, n_shards: int) -> dict:
    """What one sharded GS frame sends across one slab boundary, both
    directions summed."""
    t, TYp, TX, rows = sharded_tile_geometry(config, n_shards)
    cap = config.tile_cap
    row_block = cap * _E * TX * 4  # one 2-row f32/i32 plane block
    start = 5 * row_block * 2      # x, y, r, pid, occ, both directions
    per_color = 2 * row_block * 2  # the x, y refresh
    return {"tile_rows": TYp, "tile_cols": TX, "cap": cap,
            "rows_per_shard": rows,
            "frame_start_bytes": start,
            "per_color_refresh_bytes": per_color,
            "total_bytes_per_frame": start + 3 * per_color,
            "exchanges_per_frame": 4}


def make_sharded_gs_solve(config: SimConfig, mesh: Mesh):
    """``solve(slabs) -> slabs``: one GS frame on the slabs, positions
    solved, the occupants clamped past K summed into overflow_count."""
    n = mesh.size
    t, TYp, TX, rows = sharded_tile_geometry(config, n)
    if rows <= 2 * _E:
        raise AssertionError(
            f"slab of {rows} tile rows cannot carry {2 * _E} ghost rows — "
            "fewer shards or a bigger world")
    K = config.max_occupancy

    def exch(planes):
        """(from above, from below), each [cap, E, TX] per slab; the mesh
        edges get zeros (a zero pid reads as live: pid rows are masked
        with the occupancy)."""
        from_below = mesh.ppermute([p[:, :_E] for p in planes], -1)
        from_above = mesh.ppermute([p[:, -_E:] for p in planes], 1)
        return from_above, from_below

    def ext_join(planes) -> List[torch.Tensor]:
        top, bot = exch(planes)
        return [torch.cat([a, p, b], dim=1) for a, p, b in
                zip(top, planes, bot)]

    def inner(planes) -> List[torch.Tensor]:
        return [p[:, _E:-_E] for p in planes]

    def solve(slabs: Sequence[TileState]) -> List[TileState]:
        ex = ext_join([s.x for s in slabs])
        ey = ext_join([s.y for s in slabs])
        er = ext_join([s.radius for s in slabs])
        eocc = ext_join([s.pid >= 0 for s in slabs])
        pa, pb = exch([s.pid for s in slabs])
        tables, over = [], []
        for i, s in enumerate(slabs):
            neg = torch.full_like(pa[i], -1)
            epid = torch.cat([torch.where(eocc[i][:, :_E], pa[i], neg),
                              s.pid,
                              torch.where(eocc[i][:, -_E:], pb[i], neg)],
                             dim=1)
            est = s.replace(x=ex[i], y=ey[i], px=ex[i], py=ey[i],
                            radius=er[i], pid=epid)
            ty0 = i * rows - _E  # global row of extended row 0
            src, _, count = gs_tiled.rank_tables(
                est, gs_tiled.memberships(est, t, row0=ty0), K)
            cap, TYe, _ = est.dims
            ty = torch.arange(TYe, device=s.device).view(1, TYe, 1)
            tx = torch.arange(TX, device=s.device).view(1, 1, TX)
            idx, valid = gs_tiled.source_index(src, cap, TYe, TX, ty, tx)
            tables.append((src, gs_tiled.gather(er[i], idx, valid), ty0))
            # the clamp is counted on the slab's own rows only
            over.append(torch.sum(torch.clamp(count[_E:-_E] - K, min=0),
                                  dtype=_I32))
        for color in (1, 2, 3, 4):
            if color > 1:
                # the ghosts are the neighbours' rows after the last color
                ex = ext_join(inner(ex))
                ey = ext_join(inner(ey))
            for i, (src, rrad, ty0) in enumerate(tables):
                gs_tiled.color_plain_(ex[i], ey[i], src, rrad, config, color,
                                      row0=ty0)
        total = mesh.psum(over)[0]
        out = [s.replace(x=x.contiguous(), y=y.contiguous())
               for s, x, y in zip(slabs, inner(ex), inner(ey))]
        return with_counters(out, overflow_count=slabs[0].overflow_count
                             + total)

    return solve
