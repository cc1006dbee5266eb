"""Gauss-Seidel solve on tile storage as plain tensor ops
(``gpu_physics_engine_tpu.ops.gs_tiled``).

Reference semantics: tiles are the reference's grid cells (tile_multiplier
2.2), cell membership (a circle strictly overlapping the cell's box) is
frozen at frame start, and four color passes each run, in every cell of
their color, the sequential ascending-(a, b) pair sweep over the cell's
<= K ascending-pid occupants with the scalar model's f32 op order.  Each
cell writes its updated occupants back to their storage slots (cells of
one color are particle-disjoint: cell edge >= 2 r_max); the JAX package's
pull by pid match gives the same positions.  Occupants past K are clamped
and counted in overflow_count.

PyTorch runs each op on its own and writes its result, so ``a*b + c`` is
never contracted into a fused multiply-add: the JAX package's ``_noc``
guard has no counterpart here, and the results are bit-equal to it.

``rank_plain`` and ``colors_plain`` (color passes of ``color_plain_``) are
also the plain versions of the GS kernels K5 and K6 (ops/gs_kernels), and
``solve_frame`` drives either.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.ops.integrate import f32, sqrt_rn
from gpu_physics_engine_torch.ops.tiled import (MIN_DISTANCE, TileState,
                                                shift_tiles, tile_geometry)

BIGPID = 2 ** 31 - 1
_I32 = torch.int32

# the 9 candidate offsets (dy, dx) in the fixed order of the source codes:
# code = j * cap + s names slot s of the tile at OFFS[j] from the cell
OFFS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def color_origin(color: int) -> Tuple[int, int]:
    """(ty0, tx0): the first tile row and column of ``color``; its cells
    are every second row and column from there."""
    return 1 - ((color - 1) >> 1), 1 - ((color - 1) & 1)


def memberships(state: TileState, t: float,
                row0: int = 0) -> List[torch.Tensor]:
    """Frozen membership masks, one bool [cap, TY, TX] per offset j: the
    particle in slot s of the tile at OFFS[j] from each cell is an
    occupant of that cell (its circle strictly overlaps the cell's box).
    Every product and sum is rounded on its own, as the scalar model's.
    ``row0`` is the global tile row of local row 0 (a slab of the
    sharded solve, parallel/gs_shard.py)."""
    _, TY, TX = state.dims
    dev = state.device
    tf = f32(t)
    ty = torch.arange(TY, dtype=_I32, device=dev).view(1, TY, 1) + row0
    tx = torch.arange(TX, dtype=_I32, device=dev).view(1, 1, TX)
    lox = (tx - 1).float() * tf
    loy = (ty - 1).float() * tf
    hix = lox + tf
    hiy = loy + tf
    occ = state.pid >= 0
    member = []
    for dy, dx in OFFS:
        cx = shift_tiles(state.x, dy, dx)
        cy = shift_tiles(state.y, dy, dx)
        cr = shift_tiles(state.radius, dy, dx)
        px = torch.clamp(cx, lox, hix)
        py = torch.clamp(cy, loy, hiy)
        d2 = (cx - px) * (cx - px) + (cy - py) * (cy - py)
        member.append(shift_tiles(occ, dy, dx) & (d2 < cr * cr))
    return member


def rank_tables(state: TileState, member: List[torch.Tensor], K: int):
    """Per cell, the K smallest member pids in ascending order.  Returns
    (src, rpid, count): src i32 [K, TY, TX] = source code j*cap + s or -1,
    rpid i32 [K, TY, TX] = pid or BIGPID, count i32 [TY, TX] = all
    members (past K too).  pids are unique, so a stable sort of the 9*cap
    candidate pids selects exactly what the TPU kernels' min-pid rounds
    and selection network select."""
    cand = torch.cat([
        torch.where(member[j], shift_tiles(state.pid, dy, dx),
                    torch.full_like(state.pid, BIGPID))
        for j, (dy, dx) in enumerate(OFFS)])        # [9*cap, TY, TX]
    count = torch.sum(cand < BIGPID, dim=0, dtype=_I32)
    vals, order = torch.sort(cand, dim=0, stable=True)
    vals, order = vals[:K], order[:K].to(_I32)
    if vals.shape[0] < K:  # K > 9*cap: the deeper ranks stay empty
        pad = (K - vals.shape[0],) + tuple(vals.shape[1:])
        vals = torch.cat([vals, torch.full(pad, BIGPID, dtype=_I32,
                                           device=vals.device)])
        order = torch.cat([order, torch.full(pad, -1, dtype=_I32,
                                             device=order.device)])
    src = torch.where(vals < BIGPID, order, torch.full_like(order, -1))
    return src, vals, count


def source_index(src: torch.Tensor, cap: int, TY: int, TX: int,
                 ty: torch.Tensor, tx: torch.Tensor):
    """(flat index into a [cap, TY, TX] plane, valid) for each source code
    of ``src`` [K, ...]; ``ty``/``tx`` are the cells' tile coordinates,
    broadcastable to ``src``.  Empty ranks index slot 0."""
    valid = src >= 0
    code = torch.where(valid, src, torch.zeros_like(src)).long()
    j = code // cap
    s = code - j * cap
    nty = (ty + j // 3 - 1) % TY   # wraps like the rolled views (the
    ntx = (tx + j % 3 - 1) % TX    # border ring is empty either way)
    idx = (s * TY + nty) * TX + ntx
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


def gather(plane: torch.Tensor, idx: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """plane's values at ``idx`` (flat), 0 where not ``valid``."""
    v = plane.reshape(-1)[idx]
    return torch.where(valid, v, torch.zeros_like(v))


def pair_correction(xa, ya, ra, xb, yb, rb, stiffness: float):
    """The positional correction of the pair (a, b), in the scalar model's
    f32 op order: the division by dist, corr = dir * pen * stiffness, then
    the inverse-mass split.  Returns (dxa, dya, dxb, dyb, hit): a moves by
    +(dxa, dya) and b by -(dxb, dyb) where ``hit``."""
    mind = f32(MIN_DISTANCE)
    dx = xa - xb
    dy = ya - yb
    dist = sqrt_rn(dx * dx + dy * dy)
    rsum = ra + rb
    hit = (rsum * rsum > dist * dist) & (dist > mind)
    safe = torch.clamp(dist, min=mind)
    pen = rsum - dist
    cx = dx / safe * pen * stiffness
    cy = dy / safe * pen * stiffness
    rs = torch.clamp(rsum, min=mind)
    wa = rb / rs
    wb = ra / rs
    return cx * wa, cy * wa, cx * wb, cy * wb, hit


def ordered_sweep(lx: List, ly: List, lr: List, valid: List, stiffness,
                  active=None):
    """The reference's sequential ascending (a, b) pair sweep on rank-local
    values (``pair_correction`` per pair, later pairs seeing earlier
    corrections).  Updates ``lx``/``ly`` (lists of tensors) and returns
    them."""
    K = len(lx)
    stiff = f32(stiffness)
    for a in range(K - 1):
        for b in range(a + 1, K):
            dxa, dya, dxb, dyb, hit = pair_correction(
                lx[a], ly[a], lr[a], lx[b], ly[b], lr[b], stiff)
            hit = hit & valid[a] & valid[b]
            if active is not None:
                hit = hit & active
            lx[a] = torch.where(hit, lx[a] + dxa, lx[a])
            ly[a] = torch.where(hit, ly[a] + dya, ly[a])
            lx[b] = torch.where(hit, lx[b] - dxb, lx[b])
            ly[b] = torch.where(hit, ly[b] - dyb, ly[b])
    return lx, ly


def rank_plain(state: TileState, config: SimConfig):
    """The frame's frozen rank tables (src, rpid, rrad, count), as K5
    (ops/gs_kernels) computes them: src, rpid and count of
    ``rank_tables`` and rrad the radius of each rank (0 where empty)."""
    t, TY, TX = tile_geometry(config)
    cap = state.dims[0]
    src, rpid, count = rank_tables(state, memberships(state, t),
                                   config.max_occupancy)
    ty = torch.arange(TY, device=state.device).view(1, TY, 1)
    tx = torch.arange(TX, device=state.device).view(1, 1, TX)
    idx, valid = source_index(src, cap, TY, TX, ty, tx)
    return src, rpid, gather(state.radius, idx, valid), count


def color_plain_(x, y, src, rrad, config: SimConfig, color: int,
                 row0: int = 0) -> None:
    """Color pass ``color`` (1..4) in place on x, y [cap, TY, TX], as K6
    computes it: every cell of that color (every second row and column)
    sweeps its ranked occupants at their current positions and writes them
    back to their source slots.  ``row0`` is the global tile row of local
    row 0: a cell's color follows its global row."""
    cap, TY, TX = x.shape
    ty0, tx0 = color_origin(color)
    ty0 = (ty0 - row0) % 2
    sub = (slice(None), slice(ty0, None, 2), slice(tx0, None, 2))
    ty = torch.arange(ty0, TY, 2, device=x.device).view(1, -1, 1)
    tx = torch.arange(tx0, TX, 2, device=x.device).view(1, 1, -1)
    idx, valid = source_index(src[sub], cap, TY, TX, ty, tx)
    lx, ly = ordered_sweep(list(gather(x, idx, valid)),
                           list(gather(y, idx, valid)), list(rrad[sub]),
                           list(valid), config.stiffness)
    dst = idx[valid]
    x.view(-1)[dst] = torch.stack(lx)[valid]
    y.view(-1)[dst] = torch.stack(ly)[valid]


def colors_plain(x, y, src, rrad, config: SimConfig, c1: int = 4,
                 count=None):
    """Colors 1..c1 of one solve on copies of x, y [cap, TY, TX] (the
    inputs are not written), as K6 computes them: ``color_plain_`` per
    color.  ``count`` (K5's count table, the kernels' rank counts) is not
    read: the valid ranks are src's prefix.  Returns the new (x, y)."""
    x, y = x.clone(), y.clone()
    for c in range(1, c1 + 1):
        color_plain_(x, y, src, rrad, config, c)
    return x, y


def solve_frame(state: TileState, config: SimConfig, rank_fn,
                colors_fn) -> Tuple[TileState, tuple]:
    """Rank once, then colors 1..4 into new x and y; the occupants clamped
    past K (sum of max(count - K, 0)) add to overflow_count.  Returns (new
    state, rank tables).  ``rank_fn``/``colors_fn`` pick the route (the
    plain versions here, or ops/gs_kernels' kernels or wrappers), so the
    card checks can hold the kernels against the plain versions on the
    same input."""
    tables = rank_fn(state, config)
    src, _, rrad, count = tables
    overflow = torch.sum(torch.clamp(count - config.max_occupancy, min=0),
                         dtype=_I32)
    x, y = colors_fn(state.x, state.y, src, rrad, config, count=count)
    return state.replace(x=x, y=y, overflow_count=state.overflow_count
                         + overflow), tables


def gs_solve(state: TileState, config: SimConfig) -> TileState:
    """One frame of the 4-color Gauss-Seidel solve in plain tensor ops.
    Positions move; the storage layout does not."""
    return solve_frame(state, config, rank_plain, colors_plain)[0]
