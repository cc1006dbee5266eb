"""Narrow phase: collision-cell extraction and the positional solvers
(``gpu_physics_engine_tpu.ops.collision``).

  * Collision cells (runs of >= 2 occupants in the sorted pair array) come
    from boundary masks and one prefix sum.
  * ``solve_colored``: the reference's 4-color Gauss-Seidel schedule.  Cell
    color 1 + (cx%2) + 2*(cy%2); within one color, cells share no particles
    (cell edge >= 2 r_max), so each color loads its cells' occupants into
    per-slot vectors, runs the sequential ascending (i, j) pair sweep on
    them (ops/gs_tiled.ordered_sweep, the scalar model's f32 op order) and
    writes them back.  PyTorch rounds every operation on its own, so the
    JAX package's FMA guard has no counterpart here.
  * ``solve_jacobi``: each particle gathers its own half of every
    overlapping pair from the 3x3 home cells of a home-only bucket table.

Occupancy is clamped to K = SimConfig.max_occupancy and the surplus
counted.  JAX drops out-of-range scatters; torch raises, so the writes
that JAX sends out of range go to one spare row at the end, which is
dropped.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gpu_physics_engine_torch.core.config import SimConfig, UNUSED_CELL_ID
from gpu_physics_engine_torch.ops import morton
from gpu_physics_engine_torch.ops.grid import (BUCKET_EMPTY, Buckets,
                                               Candidates)
from gpu_physics_engine_torch.ops.gs_tiled import (ordered_sweep,
                                                   pair_correction)
from gpu_physics_engine_torch.ops.integrate import f32
from gpu_physics_engine_torch.ops.scan import inclusive_scan

_I32 = torch.int32
_I64 = torch.int64


# ---------------------------------------------------------------------------
# collision-cell extraction on sorted pairs
# ---------------------------------------------------------------------------

def _shifted(a: torch.Tensor, by: int) -> torch.Tensor:
    """a moved by one place (by = +1: a[i-1] at i; -1: a[i+1] at i), the
    vacated end filled with UNUSED."""
    fill = a.new_full((1,), UNUSED_CELL_ID)
    return (torch.cat([fill, a[:-1]]) if by > 0
            else torch.cat([a[1:], fill]))


def run_starts(sorted_cells: torch.Tensor) -> torch.Tensor:
    """bool [4N]: the first element of every run of equal, used cell ids."""
    return ((sorted_cells != UNUSED_CELL_ID)
            & (sorted_cells != _shifted(sorted_cells, 1)))


def collision_cell_mask(sorted_cells: torch.Tensor) -> torch.Tensor:
    """bool [4N]: run starts whose run has >= 2 occupants."""
    return run_starts(sorted_cells) & (_shifted(sorted_cells, -1)
                                       == sorted_cells)


def build_collision_cells(sorted_cells: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compacted start indices of the collision cells (int64 [4N], UNUSED
    padded) and their count (i32 [])."""
    mask = collision_cell_mask(sorted_cells)
    n = sorted_cells.shape[0]
    total = torch.sum(mask, dtype=_I32)
    offsets = inclusive_scan(mask.to(_I64)) - 1
    idx = torch.arange(n, dtype=_I64, device=sorted_cells.device)
    out = torch.full((n + 1,), UNUSED_CELL_ID, dtype=_I64,
                     device=sorted_cells.device)
    out[torch.where(mask, offsets, n)] = idx   # unmarked -> the spare row
    return out[:n], total


# ---------------------------------------------------------------------------
# occupant tables, the common currency of both pipelines
# ---------------------------------------------------------------------------

class OccupantTable(NamedTuple):
    """Cell occupant lists in ascending object-id order.

    obj:      i32 [M, K] occupant object ids (0 where invalid)
    valid:    bool [M, K]
    color:    i32 [M] checkerboard color 1..4 of the cell
    active:   bool [M] the row is a collision cell (>= 2 occupants)
    overflow: i32 [] occupants beyond K, summed
    """
    obj: torch.Tensor
    valid: torch.Tensor
    color: torch.Tensor
    active: torch.Tensor
    overflow: torch.Tensor


def _color(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    return (1 + (cx & 1) + 2 * (cy & 1)).to(_I32)


def occupants_from_sorted(sorted_cells, sorted_objs, K: int,
                          max_cells: int | None = None) -> OccupantTable:
    """Occupant table of the collision cells of the sorted pair array,
    compacted to ``max_cells`` rows (default len/4: one per particle
    slot).  Dropped cells and runs longer than K count in ``overflow``."""
    n = sorted_cells.shape[0]
    dev = sorted_cells.device
    if max_cells is None:
        max_cells = n // 4
    starts_idx, total = build_collision_cells(sorted_cells)
    active = torch.arange(max_cells, dtype=_I32, device=dev) < total
    s = torch.where(active, starts_idx[:max_cells], 0)

    cols, valids = [], []
    cell0 = sorted_cells[s]
    for k in range(K):
        j = torch.clamp(s + k, max=n - 1)
        same = (sorted_cells[j] == cell0) & ((s + k) < n) & active
        cols.append(torch.where(same, sorted_objs[j], 0))
        valids.append(same)
    jK = torch.clamp(s + K, max=n - 1)
    over = active & (sorted_cells[jK] == cell0) & ((s + K) < n)
    dropped = torch.clamp(total - max_cells, min=0)
    cx, cy = morton.morton_decode(cell0)
    return OccupantTable(
        obj=torch.stack(cols, dim=-1), valid=torch.stack(valids, dim=-1),
        color=_color(cx, cy), active=active,
        overflow=torch.sum(over, dtype=_I32) + dropped)


def occupants_from_buckets(buckets: Buckets,
                           config: SimConfig) -> OccupantTable:
    """One row per grid cell; active where >= 2 occupants."""
    nx, _ = config.grid_dims
    obj, valid = buckets.occupants()
    count = torch.sum(valid, dim=-1, dtype=_I32)
    lin = torch.arange(config.num_cells, dtype=_I64, device=obj.device)
    # undo the -1 border offset; (-1 & 1) is 1, as the reference's u32
    # wrap gives
    cx = lin % nx - 1
    cy = lin // nx - 1
    return OccupantTable(obj=obj, valid=valid & (count >= 2)[:, None],
                         color=_color(cx, cy), active=count >= 2,
                         overflow=buckets.overflow)


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def solve_colored(x, y, radius, table: OccupantTable, stiffness: float,
                  num_colors: int = 4):
    """4-color Gauss-Seidel positional solve, the reference's semantics:
    per color, load the occupants of that color's collision cells, run the
    sequential ascending pair sweep on them and write them back."""
    K = table.obj.shape[1]
    cap = x.shape[0]
    # one spare slot at the end takes the writes of masked entries
    x = torch.cat([x, x.new_zeros(1)])
    y = torch.cat([y, y.new_zeros(1)])
    for c in range(1, num_colors + 1):
        sel = table.active & (table.color == c)
        svalid = [table.valid[:, k] & sel for k in range(K)]
        oid = [torch.where(svalid[k], table.obj[:, k], 0).to(_I64)
               for k in range(K)]
        lx = [x[o] for o in oid]
        ly = [y[o] for o in oid]
        lr = [radius[o] for o in oid]
        ordered_sweep(lx, ly, lr, svalid, stiffness)
        dst = torch.cat([torch.where(v, o, cap) for v, o in zip(svalid, oid)])
        x[dst] = torch.cat(lx)
        y[dst] = torch.cat(ly)
    return x[:cap], y[:cap]


def solve_jacobi(x, y, radius, home_buckets: Buckets, cand: Candidates,
                 config: SimConfig, active):
    """Gather-only Jacobi solve over the 3x3 neighbourhood of home cells:
    each particle sums its own half of every overlapping pair's correction
    (home cells are unique, so each pair is found once per side)."""
    nx, ny = config.grid_dims
    K = config.max_occupancy
    entries = home_buckets.entries
    hx = cand.coords[:, 0, 0].to(_I64)
    hy = cand.coords[:, 0, 1].to(_I64)
    me = torch.arange(x.shape[0], dtype=_I32, device=x.device)

    acc_x = torch.zeros_like(x)
    acc_y = torch.zeros_like(y)
    one = f32(1.0)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ncx = hx + dx
            ncy = hy + dy
            # home cells have coords >= 0; the -1 border holds no homes
            in_range = ((ncx >= 0) & (ncx < nx - 1) & (ncy >= 0)
                        & (ncy < ny - 1))
            lin = torch.where(in_range, (ncy + 1) * nx + (ncx + 1), 0)
            for k in range(K):
                enc = entries[lin, k]
                j = enc >> 2
                ok = in_range & (enc != BUCKET_EMPTY) & (j != me) & active
                jj = torch.where(ok, j, 0).to(_I64)
                cxi, cyi, _, _, hit = pair_correction(
                    x, y, radius, x[jj], y[jj], radius[jj], one)
                apply = ok & hit
                acc_x = torch.where(apply, acc_x + cxi, acc_x)
                acc_y = torch.where(apply, acc_y + cyi, acc_y)
    stiff = f32(config.stiffness)
    return x + acc_x * stiff, y + acc_y * stiff
