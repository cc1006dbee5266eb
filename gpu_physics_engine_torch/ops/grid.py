"""Uniform spatial grid broad phase (``gpu_physics_engine_tpu.ops.grid``).

Every step each particle reports the cells it overlaps: its home cell plus
up to 3 phantom neighbour cells found by a strict circle-vs-cell-box test.
Two groupings, selected by SimConfig.pipeline:

  1. "sorted": a flat 4N array of (Morton cell id, object id) pairs with
     UNUSED = 0xFFFFFFFF padding, stably sorted by cell id (ops/sort).
     Runs of equal ids are the cell occupant lists.
  2. "bucket": a dense [num_cells, K] occupant table built with K rounds of
     scatter-min ("lowest object id wins slot k"), no global sort.

Both give occupant lists in ascending object order.  Cell ids are u32
values held in int64 tensors (ops/morton).  ``cell_size`` is a 0-d f32
tensor on the particles' device: ``x / cell_size`` then divides on the
card too, where a division by a Python float multiplies by its
reciprocal and can move a particle on a cell edge into the next cell.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gpu_physics_engine_torch.core.config import SimConfig, UNUSED_CELL_ID
from gpu_physics_engine_torch.ops import morton
from gpu_physics_engine_torch.ops.sort import sort_pairs

_I32 = torch.int32
_I64 = torch.int64

# Encoded bucket entries are obj_id * 4 + candidate_slot; EMPTY sorts last.
BUCKET_EMPTY = 0x7FFFFFFF

# the reference's neighbour scan order: y from -1 to 1, x from -1 to 1
_NEIGHBOR_OFFSETS = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                     if not (dx == 0 and dy == 0)]


def home_cells(x: torch.Tensor, y: torch.Tensor, cell_size: torch.Tensor):
    """Integer grid coords (i32) of each particle's home cell."""
    cx = torch.floor(x / cell_size).to(_I32)
    cy = torch.floor(y / cell_size).to(_I32)
    return cx, cy


def _circle_in_cell(x, y, sq_radius, ncx, ncy, cell_size):
    """Strict circle-vs-cell-box overlap test."""
    lo_x = ncx.float() * cell_size
    lo_y = ncy.float() * cell_size
    closest_x = torch.minimum(torch.maximum(x, lo_x), lo_x + cell_size)
    closest_y = torch.minimum(torch.maximum(y, lo_y), lo_y + cell_size)
    dx = x - closest_x
    dy = y - closest_y
    return dx * dx + dy * dy < sq_radius


class Candidates(NamedTuple):
    """Per-particle candidate cells, 4 slots each (slot 0 = home).

    cells:  int64 [cap, 4] u32 Morton codes, UNUSED_CELL_ID for empty slots
    coords: i32 [cap, 4, 2] integer cell coords
    valid:  bool [cap, 4]
    """
    cells: torch.Tensor
    coords: torch.Tensor
    valid: torch.Tensor


def build_candidates(x, y, radius, active, cell_size) -> Candidates:
    """Home + phantom candidate cells for every particle slot; the phantom
    hits are compacted into slots 1..3 in neighbour scan order."""
    sq_r = radius * radius
    hx, hy = home_cells(x, y, cell_size)

    hits, hit_cells, hit_coords = [], [], []
    for dx, dy in _NEIGHBOR_OFFSETS:
        ncx, ncy = hx + dx, hy + dy
        hits.append(_circle_in_cell(x, y, sq_r, ncx, ncy, cell_size)
                    & active)
        hit_cells.append(morton.morton_encode(ncx, ncy))
        hit_coords.append(torch.stack([ncx, ncy], dim=-1))
    hits = torch.stack(hits, dim=-1)                    # [cap, 8]
    hit_cells = torch.stack(hit_cells, dim=-1)          # [cap, 8]
    hit_coords = torch.stack(hit_coords, dim=-2)        # [cap, 8, 2]
    # rank of each hit among this particle's hits, in scan order
    rank = torch.cumsum(hits.to(_I32), dim=-1) - 1

    cells = [morton.morton_encode(hx, hy)]
    coords = [torch.stack([hx, hy], dim=-1)]
    valids = [active]
    for slot in range(3):
        take = hits & (rank == slot)                    # one True at most
        any_take = take.any(dim=-1)
        # the single hit's code (the others 0); codes are >= 0 as int64,
        # so this is the JAX package's max over u32
        cell = torch.where(take, hit_cells, 0).amax(dim=-1)
        coord = torch.where(take[..., None], hit_coords, 0).sum(
            dim=-2, dtype=_I32)
        cells.append(torch.where(any_take, cell, UNUSED_CELL_ID))
        coords.append(coord)
        valids.append(any_take)

    valid = torch.stack(valids, dim=-1)
    cells = torch.where(valid, torch.stack(cells, dim=-1), UNUSED_CELL_ID)
    return Candidates(cells=cells, coords=torch.stack(coords, dim=-2),
                      valid=valid)


# ---------------------------------------------------------------------------
# pipeline 1: sorted (cell, object) pairs
# ---------------------------------------------------------------------------

def build_cell_ids(cand: Candidates) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 4N pair layout: cell_ids int64 [4*cap] (u32 values, UNUSED
    padded) and object_ids i32 [4*cap]."""
    cap = cand.cells.shape[0]
    object_ids = torch.arange(cap, dtype=_I32,
                              device=cand.cells.device).repeat_interleave(4)
    return cand.cells.reshape(-1), object_ids


def sort_map(cell_ids, object_ids, impl: str = "lax"):
    """Stable sort of the pair arrays by cell id."""
    return sort_pairs(cell_ids, object_ids, impl=impl)


# ---------------------------------------------------------------------------
# pipeline 2: dense cell buckets
# ---------------------------------------------------------------------------

class Buckets(NamedTuple):
    """Dense occupant table.

    entries:  i32 [num_cells, K] encoded obj*4+slot, BUCKET_EMPTY when
              vacant, ascending within a row
    overflow: i32 [] candidate entries that did not fit in K slots
    """
    entries: torch.Tensor
    overflow: torch.Tensor

    def occupants(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(obj_ids i32 [num_cells, K], valid bool [num_cells, K])."""
        valid = self.entries != BUCKET_EMPTY
        return torch.where(valid, self.entries >> 2, 0), valid


def linear_cell_ids(coords, valid, config: SimConfig):
    """Row-major linear cell id (int64) for bucket indexing, num_cells for
    invalid entries.  The grid has a one-cell border at coordinate -1;
    the cell (-1, -1), whose Morton code is the UNUSED sentinel, is left
    out, as the reference's sort leaves it out."""
    nx, ny = config.grid_dims
    cx, cy = coords[..., 0], coords[..., 1]
    in_range = ((cx >= -1) & (cx < nx - 1) & (cy >= -1) & (cy < ny - 1)
                & valid)
    in_range = in_range & ~((cx == -1) & (cy == -1))
    lin = (cy.to(_I64) + 1) * nx + (cx.to(_I64) + 1)
    return torch.where(in_range, lin, config.num_cells), in_range


def build_buckets(cand: Candidates, config: SimConfig,
                  home_only: bool = False) -> Buckets:
    """Scatter candidates into a dense [num_cells, K] occupant table: in
    round k every unplaced candidate proposes its code for slot k of its
    cell, the minimum (lowest object id) wins, winners retire.  Candidates
    left after K rounds are counted in ``overflow``.  ``home_only`` keeps
    the home candidates only (the Jacobi solver's table)."""
    K = config.max_occupancy
    nslots = 1 if home_only else 4
    coords = cand.coords[:, :nslots]
    valid = cand.valid[:, :nslots]
    dev = valid.device

    cell, in_range = linear_cell_ids(coords, valid, config)
    cell = cell.reshape(-1)
    slot_idx = torch.arange(nslots, dtype=_I32, device=dev).repeat(
        valid.shape[0])
    obj = torch.arange(valid.shape[0], dtype=_I32,
                       device=dev).repeat_interleave(nslots)
    enc = obj * 4 + slot_idx

    placed = ~in_range.reshape(-1)
    rows = []
    for _ in range(K):
        proposal = torch.where(placed, BUCKET_EMPTY, enc)
        row = torch.full((config.num_cells + 1,), BUCKET_EMPTY, dtype=_I32,
                         device=dev)
        row.scatter_reduce_(0, cell, proposal, reduce="amin")
        won = (row[cell] == proposal) & ~placed
        placed = placed | won
        rows.append(row[:-1])
    entries = torch.stack(rows, dim=-1)
    overflow = torch.sum(~placed, dtype=_I32)
    return Buckets(entries=entries, overflow=overflow)
