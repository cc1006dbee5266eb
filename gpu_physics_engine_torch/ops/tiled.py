"""Persistent tiled pipeline on PyTorch tensors (``gpu_physics_engine_tpu.ops.tiled``).

Storage IS the grid: every per-particle field lives in a dense
``[CAP, TY, TX]`` tensor, slot k of tile (ty, tx), with a one-tile empty
border ring.  Per frame the pull relocate moves storage one hop toward
each particle's home tile (ops/tiled_kernels.relocate_pull), then one fused
pass runs the 3x3 x CAP Jacobi pair sweep and the Verlet integration
(ops/tiled_kernels.collide_integrate).  Periodically an exact sweep
restores storage == home: the claim ``relocate`` or the wholesale
``rebuild``.  Spawns enter through ``spawn_insert_into``: the home tile,
ring 1, then the nearest free tile the host finds.

Everything here is plain PyTorch and runs on whatever device the state
lives on.  The hot passes dispatch to hand-written CUDA kernels for CUDA
tensors (``tiled_step_fn``): ops/tiled_kernels for the Jacobi sweep and
the relocate, ops/gs_kernels and ops/gs_parity for the Gauss-Seidel solve.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.state import StepParams
from gpu_physics_engine_torch.ops.integrate import f32, verlet_integrate

MIN_DISTANCE = 1e-4
_EMPTY = -1
_BIG = 0x7FFFFFFF
_I32 = torch.int32

FIELDS = ("x", "y", "px", "py", "radius", "pid")


# ---------------------------------------------------------------------------
# geometry + state
# ---------------------------------------------------------------------------

def tile_geometry(config: SimConfig) -> Tuple[float, int, int]:
    """(tile_edge, TY, TX) including the 1-tile empty border ring.  TY is
    rounded up to a multiple of 8, as in the JAX package, so shapes match
    it; the extra rows sit above the world and stay empty."""
    t = config.tile_multiplier * config.tile_max_radius_effective
    tx = int(math.ceil(config.world_width / t)) + 2
    ty = int(math.ceil(config.world_height / t)) + 2
    return t, -(-ty // 8) * 8, tx


@dataclasses.dataclass
class TileState:
    """Dense tile-resident particle state: ``[CAP, TY, TX]`` f32 planes,
    an i32 ``pid`` plane (-1 marks an empty slot) and i32 0-d counters on
    the same device."""
    x: torch.Tensor
    y: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    radius: torch.Tensor
    pid: torch.Tensor
    num_active: torch.Tensor
    overflow_count: torch.Tensor

    @property
    def dims(self):
        return tuple(self.x.shape)  # (CAP, TY, TX)

    @property
    def device(self) -> torch.device:
        return self.x.device

    def occupied(self) -> torch.Tensor:
        return self.pid >= 0

    def replace(self, **kw) -> "TileState":
        return dataclasses.replace(self, **kw)


def to_numpy(state: TileState) -> Dict[str, np.ndarray]:
    """Host copy of every field, keyed by the TileState field names (the
    JAX package's TileState carries the same keys)."""
    return {f.name: getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(TileState)}


def from_numpy(arrays: Dict[str, np.ndarray], device=None) -> TileState:
    """TileState from host arrays keyed like ``to_numpy``'s output (also
    ``{f: np.asarray(getattr(jax_state, f))}`` of a JAX TileState)."""
    device = torch.device(device or "cpu")

    def t(name, dtype):
        a = np.array(arrays[name], dtype)  # a writable copy
        return torch.from_numpy(a).to(device)

    return TileState(
        x=t("x", np.float32), y=t("y", np.float32),
        px=t("px", np.float32), py=t("py", np.float32),
        radius=t("radius", np.float32), pid=t("pid", np.int32),
        num_active=t("num_active", np.int32).reshape(()),
        overflow_count=t("overflow_count", np.int32).reshape(()))


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(int(v), dtype=_I32, device=device)


def _iota(shape, dim: int, device) -> torch.Tensor:
    """int32 index along ``dim`` broadcast to ``shape``."""
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return torch.arange(shape[dim], dtype=_I32, device=device).view(view)


def _tile_of(x: torch.Tensor, y: torch.Tensor, tile_edge: float):
    """Tile coords (+1 border offset) of world positions: floor(pos / t)
    by a correctly rounded f32 division.  The edge is a 0-d f32 tensor on
    the positions' device: PyTorch's CUDA division by a Python float
    multiplies by its reciprocal, which puts some positions within an ulp
    of a tile edge in the neighbouring tile."""
    t = torch.tensor(f32(tile_edge), dtype=torch.float32, device=x.device)
    tx = torch.floor(x / t).to(_I32) + 1
    ty = torch.floor(y / t).to(_I32) + 1
    return ty, tx


def init_tiles(config: SimConfig, positions, radii, pids=None,
               previous_positions=None, device=None) -> TileState:
    """Host-side construction from particle arrays.

    A stable sort by tile gives each particle its rank in its tile; the
    ones past ``tile_cap`` spill, in ascending particle order, to the
    nearest tile with room (rings widening out to the whole grid; the
    spill pass is C++, ops/native/tiler.cpp, for a dense pile's spills).
    This is the JAX package's numpy path, whose layout equals its native
    tiler's."""
    t, TY, TX = tile_geometry(config)
    cap = config.tile_cap
    device = torch.device(device or "cpu")
    positions = np.ascontiguousarray(positions, np.float32).reshape(-1, 2)
    radii = np.ascontiguousarray(radii, np.float32).reshape(-1)
    n = radii.shape[0]
    if n and float(radii.max()) * 2.0 > t:
        raise ValueError(
            f"tile edge {t:.3f} < particle diameter {2 * radii.max():.3f}: "
            "the 3x3 neighborhood would miss pairs. Raise "
            "SimConfig.tile_max_radius (or tile_multiplier).")
    if previous_positions is None:
        previous_positions = positions
    previous_positions = np.ascontiguousarray(
        previous_positions, np.float32).reshape(-1, 2)
    if pids is None:
        pids = np.arange(n, dtype=np.int32)
    pids = np.ascontiguousarray(pids, np.int32)

    shape = (cap, TY, TX)
    size = cap * TY * TX
    ty = np.clip((positions[:, 1] // t).astype(np.int64) + 1, 1, TY - 2)
    tx = np.clip((positions[:, 0] // t).astype(np.int64) + 1, 1, TX - 2)
    tile = ty * TX + tx
    order = np.argsort(tile, kind="stable")
    tile_sorted = tile[order]
    first = np.concatenate([[0], np.nonzero(np.diff(tile_sorted))[0] + 1])
    run_start = np.zeros(n, np.int64)
    run_start[first[first < n]] = first[first < n]
    run_start = np.maximum.accumulate(run_start)
    slot = np.arange(n, dtype=np.int64) - run_start

    keep = slot < cap
    flat = [slot[keep] * (TY * TX) + tile_sorted[keep]]
    src = [order[keep]]

    fill = np.bincount(tile, minlength=TY * TX)
    np.minimum(fill, cap, out=fill)
    spilled = np.sort(order[~keep])  # ascending particle order
    dest = np.full(len(spilled), -1, np.int64)
    if len(spilled):
        _tiler().gpe_spill_tiles(
            np.ascontiguousarray(ty[spilled]),
            np.ascontiguousarray(tx[spilled]), len(spilled), fill, cap, TY,
            TX, dest)
    placed = dest >= 0
    dropped = int((~placed).sum())
    flat = np.concatenate(flat + [dest[placed]])
    src = np.concatenate(src + [spilled[placed]])

    def place(vals, fill_value=0.0, dtype=np.float32):
        a = np.full(size, fill_value, dtype)
        a[flat] = vals[src]
        return torch.from_numpy(a.reshape(shape)).to(device)

    return TileState(
        x=place(positions[:, 0]), y=place(positions[:, 1]),
        px=place(previous_positions[:, 0]), py=place(previous_positions[:, 1]),
        radius=place(radii),
        pid=place(pids, fill_value=-1, dtype=np.int32),
        num_active=_scalar(n - dropped, device),
        overflow_count=_scalar(dropped, device))


@functools.lru_cache(maxsize=None)
def _tiler():
    """The spill pass of ``init_tiles`` (ops/native/tiler.cpp), built with
    g++ at first use."""
    import ctypes
    from gpu_physics_engine_torch.ops import _native
    lib = _native.load(_native.PKG / "ops" / "native" / "tiler.cpp")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.gpe_spill_tiles.argtypes = [i64p, i64p, ctypes.c_int64, i64p,
                                    ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int32, i64p]
    lib.gpe_spill_tiles.restype = ctypes.c_int64
    return lib


def _displacement(state: TileState, config: SimConfig) -> torch.Tensor:
    """Chebyshev distance (in tiles) between each slot's storage tile and
    its occupant's home tile."""
    t, TY, TX = tile_geometry(config)
    shape = state.dims
    ty_now = _iota(shape, 1, state.device)
    tx_now = _iota(shape, 2, state.device)
    tyw, txw = _tile_of(state.x, state.y, t)
    tyw = torch.clamp(tyw, 1, TY - 2)
    txw = torch.clamp(txw, 1, TX - 2)
    return torch.maximum(torch.abs(tyw - ty_now), torch.abs(txw - tx_now))


def stale_pair_fraction(state: TileState, config: SimConfig) -> torch.Tensor:
    """Fraction of particles stored >= 2 tiles from home: the class whose
    3x3 window can miss collisions.  f32 0-d tensor on the state's
    device."""
    stale = torch.sum((_displacement(state, config) >= 2)
                      & state.occupied(), dtype=_I32)
    return stale.float() / torch.clamp(state.num_active, min=1).float()


def displaced_fraction(state: TileState, config: SimConfig) -> torch.Tensor:
    """Fraction of particles stored >= 1 tile from home (the deferred
    population).  f32 0-d tensor."""
    disp = torch.sum((_displacement(state, config) >= 1)
                     & state.occupied(), dtype=_I32)
    return disp.float() / torch.clamp(state.num_active, min=1).float()


def export_particles(state: TileState):
    """Host download: (pid, positions, previous_positions, radii) of live
    slots, sorted by pid."""
    pid_all = state.pid.cpu().numpy()
    occ = pid_all >= 0
    pid = pid_all[occ]
    order = np.argsort(pid)

    def live(a):
        return a.cpu().numpy()[occ]

    pos = np.stack([live(state.x), live(state.y)], -1)
    prev = np.stack([live(state.px), live(state.py)], -1)
    rad = live(state.radius)
    return pid[order], pos[order], prev[order], rad[order]


# ---------------------------------------------------------------------------
# collision: 3x3 shifted-window Jacobi pair sweep
# ---------------------------------------------------------------------------

def shift_tiles(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Neighbor tile view a[:, ty+dy, tx+dx]; the empty border ring makes
    the wrapped rows/columns read as vacant slots."""
    if dy == 0 and dx == 0:
        return a
    return torch.roll(a, shifts=(-dy, -dx), dims=(1, 2))


def pair_sweep(x, y, r, pid, config: SimConfig, r0=None):
    """Jacobi pair corrections over the 3x3 x CAP neighborhood: returns
    (acc_x, acc_y), each slot's half of every pair correction, summed in
    the order (dy, dx, k).  ``r0`` set = uniform-radius constants (rsum
    = 2*r0, inverse-mass split 1/2; ``r`` is not read), the JAX package's
    ``_pair_sweep(r0=...)`` math."""
    cap = x.shape[0]
    stiffness = f32(config.stiffness)
    min2 = f32(MIN_DISTANCE * MIN_DISTANCE)
    occf = (pid >= 0).float()
    if r0 is not None:
        rsum_c = f32(2.0 * r0)
        rsum2_c = f32((2.0 * r0) * (2.0 * r0))
        half_stiff = f32(0.5 * config.stiffness)
    slot = torch.arange(cap, device=x.device).view(cap, 1, 1)
    acc_x = torch.zeros_like(x)
    acc_y = torch.zeros_like(y)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            xo = shift_tiles(x, dy, dx)
            yo = shift_tiles(y, dy, dx)
            ro = None if r0 is not None else shift_tiles(r, dy, dx)
            oo = shift_tiles(occf, dy, dx)
            self_tile = dy == 0 and dx == 0
            for k in range(cap):
                ddx = x - xo[k:k + 1]
                ddy = y - yo[k:k + 1]
                d2 = ddx * ddx + ddy * ddy
                if r0 is None:
                    rk = ro[k:k + 1]
                    rsum = r + rk
                    rsum2 = rsum * rsum
                else:
                    rsum2 = rsum2_c
                pair = ((d2 < rsum2) & (d2 > min2)).float()
                if self_tile:
                    pair = pair * (slot != k).float()
                w = pair * occf * oo[k:k + 1]
                inv = torch.rsqrt(torch.clamp(d2, min=min2))
                dist = d2 * inv
                if r0 is None:
                    pen = (rsum - dist) * stiffness
                    wi = rk * torch.rsqrt(torch.clamp(rsum2, min=min2))
                    coef = inv * pen * wi * w
                else:
                    coef = inv * ((rsum_c - dist) * half_stiff) * w
                acc_x = acc_x + ddx * coef
                acc_y = acc_y + ddy * coef
    return acc_x, acc_y


def collide(state: TileState, config: SimConfig) -> TileState:
    """One Jacobi relaxation over all pairs in the 3x3 tile neighborhoods
    (general radius)."""
    acc_x, acc_y = pair_sweep(state.x, state.y, state.radius, state.pid,
                              config)
    return state.replace(x=state.x + acc_x, y=state.y + acc_y)


# ---------------------------------------------------------------------------
# integration (position Verlet over tile slots)
# ---------------------------------------------------------------------------

def integrate(state: TileState, params: StepParams, config: SimConfig,
              dt_scale: float = 1.0, prm=None) -> TileState:
    """Verlet integration over tile slots (``prm`` overrides ``params``
    with a ready device vector)."""
    if prm is None:
        prm = params.as_tensor(state.device, dt_scale)
    nx, ny, npx, npy = verlet_integrate(state.x, state.y, state.px,
                                        state.py, state.radius,
                                        state.occupied(), prm, config)
    return state.replace(x=nx, y=ny, px=npx, py=npy)


# ---------------------------------------------------------------------------
# claim relocation: compact movers -> claim free slots -> move
# ---------------------------------------------------------------------------

def _nonzero_padded(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)``: ascending indices
    of the set entries, cut to ``size`` and padded with ``fill`` (int64).
    Synchronises with the device (the count decides the shape)."""
    idx = torch.nonzero(mask).flatten()[:size]
    pad = size - idx.shape[0]
    if pad:
        idx = torch.cat([idx, torch.full((pad,), fill, dtype=idx.dtype,
                                         device=idx.device)])
    return idx


def _insert_compacted(state: TileState, ty_t, tx_t, fields, live):
    """Claim free slots in target tiles for up to M compacted entries.

    fields = (x, y, px, py, radius, pid), each [M].  Deterministic: per
    claim round the lowest entry index wins a tile's free slot k (a
    scatter-min into an ntiles+1 buffer whose last entry is the sentinel
    that entries without a claim write to).  Returns (new state, placed
    mask)."""
    cap, TY, TX = state.dims
    ntiles = TY * TX
    dev = state.device
    m = ty_t.shape[0]
    tile_lin = (ty_t.long() * TX + tx_t.long())
    enc = torch.arange(m, dtype=torch.int64, device=dev)

    flat = [a.reshape(-1).clone() for a in
            (state.x, state.y, state.px, state.py, state.radius, state.pid)]
    placed = ~live
    for k in range(cap):
        base = k * ntiles
        can = ~placed & (flat[5][base + tile_lin] < 0)
        claim = torch.full((ntiles + 1,), _BIG, dtype=torch.int64,
                           device=dev)
        claim.scatter_reduce_(
            0, torch.where(can, tile_lin, torch.full_like(tile_lin, ntiles)),
            torch.where(can, enc, torch.full_like(enc, _BIG)), "amin")
        won = can & (claim[tile_lin] == enc)
        dst = base + tile_lin[won]
        for i in range(6):
            flat[i][dst] = fields[i][won]
        placed = placed | won

    shape = state.dims
    new_state = state.replace(
        x=flat[0].view(shape), y=flat[1].view(shape),
        px=flat[2].view(shape), py=flat[3].view(shape),
        radius=flat[4].view(shape), pid=flat[5].view(shape))
    return new_state, placed & live


def relocate(state: TileState, config: SimConfig, m_cap: int | None = None,
             tile_offset=None, delta: float = 0.0) -> TileState:
    """Move boundary-crossing particles to their new tiles (deferred-safe
    claim relocate, exact multi-tile jumps).

    ``m_cap`` overrides config.mover_capacity; ``tile_offset`` rotates the
    mover-tile scan start (the buffer-overflow compaction takes a prefix
    of flat tile order); ``delta`` > 0 applies the pull relocate's
    hysteresis band to the mover test.  Movers beyond the buffer or
    without a free slot stay put and count in overflow_count.  Syncs with
    the device once (the mover-tile count)."""
    t, TY, TX = tile_geometry(config)
    if m_cap is None:
        m_cap = config.mover_capacity
    dev = state.device
    cap = state.dims[0]
    ntiles = TY * TX

    occ = state.occupied()
    ty_now = _iota(state.dims, 1, dev)
    tx_now = _iota(state.dims, 2, dev)
    ty_want, tx_want = _tile_of(state.x, state.y, t)
    ty_want = torch.clamp(ty_want, 1, TY - 2)
    tx_want = torch.clamp(tx_want, 1, TX - 2)
    if delta:
        dty, dtx = step_offsets(state.x, state.y, ty_now, tx_now, t=t,
                                delta=delta, gTY=None, gTX=None)
        mover = occ & ((dty != 0) | (dtx != 0))
    else:
        mover = occ & ((ty_want != ty_now) | (tx_want != tx_now))

    flat_mask = mover.reshape(-1)
    n_movers = torch.sum(flat_mask, dtype=_I32)

    # two-level compaction: flag tiles holding movers, compact the flags,
    # expand each flagged tile's CAP slots
    mt_cap = max(1, m_cap // cap)
    tile_mask = torch.any(mover, dim=0).reshape(-1)
    off = None
    if tile_offset is not None:
        off = int(tile_offset) % ntiles
        tile_mask = torch.roll(tile_mask, -off)
    tile_idx = _nonzero_padded(tile_mask, mt_cap, ntiles)
    tile_live = tile_idx < ntiles
    if off is not None:
        tile_idx = torch.where(tile_live, (tile_idx + off) % ntiles,
                               torch.full_like(tile_idx, ntiles))
    tile_idx = torch.where(tile_live, tile_idx, torch.zeros_like(tile_idx))
    mov_idx = (torch.arange(cap, dtype=torch.int64, device=dev)[:, None]
               * ntiles + tile_idx[None, :]).reshape(-1)
    live = tile_live[None, :].expand(cap, mt_cap).reshape(-1) \
        & flat_mask[mov_idx]
    mov_idx = torch.where(live, mov_idx, torch.zeros_like(mov_idx))

    def take(a, fill):
        v = a.reshape(-1)[mov_idx]
        return torch.where(live, v, torch.full_like(v, fill))

    fields = (take(state.x, 0.0), take(state.y, 0.0),
              take(state.px, 0.0), take(state.py, 0.0),
              take(state.radius, 0.0), take(state.pid, -1))
    ty_t = take(ty_want, 0)
    tx_t = take(tx_want, 0)
    deferred = n_movers - torch.sum(live, dtype=_I32)

    new_state, placed = _insert_compacted(state, ty_t, tx_t, fields, live)
    # vacate placed movers' old slots
    pid_flat = new_state.pid.reshape(-1)
    pid_flat[mov_idx[placed]] = _EMPTY
    not_placed = torch.sum(live & ~placed, dtype=_I32)
    return new_state.replace(
        overflow_count=state.overflow_count + deferred + not_placed)


# ---------------------------------------------------------------------------
# wholesale rebuild: one stable sort by home tile
# ---------------------------------------------------------------------------

def _home_lin(state: TileState, config: SimConfig):
    """(live, lin): flat [S] home-tile linear index (int32) with a
    dead-slot sentinel of ntiles."""
    t, TY, TX = tile_geometry(config)
    live = state.occupied()
    ty_w, tx_w = _tile_of(state.x, state.y, t)
    ty_w = torch.clamp(ty_w, 1, TY - 2)
    tx_w = torch.clamp(tx_w, 1, TX - 2)
    lin = torch.where(live, ty_w * TX + tx_w,
                      torch.full_like(ty_w, TY * TX))
    return live, lin.reshape(-1)


def _group_rank(key_sorted: torch.Tensor) -> torch.Tensor:
    """Rank of each entry within its equal-key group of an ascending
    stably-sorted key vector: its index less its group's first index (a
    binary search; PyTorch's CUDA cummax of one long row runs in one
    block)."""
    n = key_sorted.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=key_sorted.device)
    return idx - torch.searchsorted(key_sorted, key_sorted, side="left")


def rebuild(state: TileState, config: SimConfig,
            loser_cap: int = 1 << 16) -> TileState:
    """Wholesale storage rebuild: every live particle re-slotted at its
    home tile through one stable sort by home tile.

    Winners (rank < CAP within their home group) land at (rank, home);
    losers (home demand past CAP) go to the lowest free slots in flat
    order; past ``loser_cap`` they are lost loudly (num_active drops,
    overflow_count rises).  The sort's permutation gathers every field,
    so placement is bit-identical to the JAX package's value sort and its
    gather flavor alike.  Syncs with the device (loser compaction)."""
    t, TY, TX = tile_geometry(config)
    cap = state.dims[0]
    ntiles = TY * TX
    S = cap * ntiles
    dev = state.device

    _, lin = _home_lin(state, config)
    key, perm = torch.sort(lin, stable=True)
    srcs = [a.reshape(-1)[perm] for a in
            (state.x, state.y, state.px, state.py, state.radius, state.pid)]

    key = key.long()
    rank = _group_rank(key)
    in_grid = key < ntiles
    win = in_grid & (rank < cap)
    dst = (rank * ntiles + key)[win]

    outs = []
    for i, v in enumerate(srcs):
        a = torch.full((S,), _EMPTY if i == 5 else 0, dtype=v.dtype,
                       device=dev)
        a[dst] = v[win]
        outs.append(a)

    # losers: zip into the lowest free slots
    loser = in_grid & (rank >= cap)
    n_losers = torch.sum(loser, dtype=_I32)
    lidx = _nonzero_padded(loser, loser_cap, S)
    l_live = lidx < S
    lidx0 = torch.where(l_live, lidx, torch.zeros_like(lidx))
    fidx = _nonzero_padded(outs[5] < 0, loser_cap, S)
    ok = l_live & (fidx < S)
    for i, v in enumerate(srcs):
        outs[i][fidx[ok]] = v[lidx0[ok]]
    lost = n_losers - torch.sum(ok, dtype=_I32)

    shape = state.dims
    return state.replace(
        x=outs[0].view(shape), y=outs[1].view(shape),
        px=outs[2].view(shape), py=outs[3].view(shape),
        radius=outs[4].view(shape), pid=outs[5].view(shape),
        num_active=state.num_active - lost,
        overflow_count=state.overflow_count + lost)


# ---------------------------------------------------------------------------
# the band drain (tiled_sweep="bands"): stale slots moved home, row band by
# row band
# ---------------------------------------------------------------------------

def stale_per_row(state: TileState, config: SimConfig,
                  max_dy: int = 0) -> torch.Tensor:
    """i32 [TY]: live slots per storage row whose home tile is not their
    storage tile.  ``max_dy`` > 0 counts only those whose home row lies
    less than ``max_dy`` rows from the storage row: the stale mass a band
    of ``max_dy`` rows can hold at both ends."""
    t, TY, TX = tile_geometry(config)
    shape = state.dims
    ty_h, tx_h = _tile_of(state.x, state.y, t)
    ty_h = torch.clamp(ty_h, 1, TY - 2)
    tx_h = torch.clamp(tx_h, 1, TX - 2)
    ty_s = _iota(shape, 1, state.device)
    stale = state.occupied() & ((ty_h != ty_s)
                                | (tx_h != _iota(shape, 2, state.device)))
    if max_dy > 0:
        stale = stale & (torch.abs(ty_h - ty_s) < max_dy)
    return torch.sum(stale, dim=(0, 2), dtype=_I32)


def rebuild_band(state: TileState, config: SimConfig, row0: int,
                 rows: int = 16) -> TileState:
    """The drain of the ``rows`` tile rows from ``row0`` (clamped to
    [0, TY - rows]): every stale slot of the band whose home tile lies in
    the band and has a dead slot moves home; every other slot stays where
    it is, so num_active and overflow_count do not change.

    The movers are ranked within their home tile by a stable sort of
    (home tile, source slot); the j-th mover of a tile takes the tile's
    j-th dead slot (ascending k), as in the JAX package.  Chains resolve
    over successive drains: a departing slot is a dead slot for the next.
    Rows outside the band are untouched.  Plain PyTorch; nothing is read
    back to the host."""
    t, TY, TX = tile_geometry(config)
    cap = state.dims[0]
    rows = min(rows, TY)
    row0 = min(max(int(row0), 0), TY - rows)
    NT = rows * TX
    S = cap * NT
    dev = state.device
    bands = [getattr(state, f)[:, row0:row0 + rows].reshape(-1)
             for f in FIELDS]
    bx, by, bpid = bands[0], bands[1], bands[5]

    live = (bpid >= 0).view(cap, NT)
    ty_h, tx_h = _tile_of(bx, by, t)
    ty_h = torch.clamp(ty_h, 1, TY - 2)
    tx_h = torch.clamp(tx_h, 1, TX - 2)
    bty = (ty_h - row0).view(cap, NT)  # band-local home row
    lin_home = bty * TX + tx_h.view(cap, NT)
    t_store = torch.arange(NT, dtype=_I32, device=dev)[None, :]
    mover = live & (bty >= 0) & (bty < rows) & (lin_home != t_store)

    key = torch.where(mover, lin_home, NT).reshape(-1).long()
    key_s, src_s = torch.sort(key, stable=True)
    rank = _group_rank(key_s)
    in_band = key_s < NT

    # slot_of[tile * cap + j] = k of the tile's j-th dead slot
    dead = ~live
    dead_i = dead.to(_I32)
    deadrank = torch.cumsum(dead_i, dim=0, dtype=_I32) - dead_i
    ndead = torch.sum(dead_i, dim=0, dtype=_I32)
    slot_pos = torch.where(dead, t_store * cap + deadrank, NT * cap)
    slot_src = torch.arange(cap, dtype=_I32, device=dev)[:, None].expand(
        cap, NT)
    slot_of = torch.zeros(NT * cap + 1, dtype=_I32, device=dev)
    slot_of[slot_pos.reshape(-1).long()] = slot_src.reshape(-1)

    key_c = torch.clamp(key_s, max=NT - 1)
    win = in_band & (rank < ndead[key_c])
    dst_k = slot_of[key_c * cap + torch.clamp(rank, max=cap - 1)].long()
    # a winner's source is live and its destination dead: disjoint, so
    # clearing the sources and then filling the destinations never
    # collides; the losers' writes go to the spare slot S
    dst = torch.where(win, dst_k * NT + key_c, S)
    win_src = torch.where(win, src_s, S)
    src_g = torch.where(win, src_s, 0)

    out = {}
    for f, flat in zip(FIELDS, bands):
        vals = flat[src_g]
        moved = torch.cat([flat, flat.new_zeros(1)])
        moved[win_src] = _EMPTY if f == "pid" else 0
        moved[dst] = vals
        plane = getattr(state, f).clone()
        plane[:, row0:row0 + rows] = moved[:S].view(cap, rows, TX)
        out[f] = plane
    return state.replace(**out)


# ---------------------------------------------------------------------------
# spawn inserts: home tile, then ring 1, then the host's far spill
# ---------------------------------------------------------------------------

# The reference never refuses a spawn (its arrays grow and its grid is
# rebuilt), so a spawn whose home tile is storage-full goes to a nearby
# tile: off-home storage is a deferred mover that the pull relocate walks
# home.  Only a full interior grid refuses, into overflow_count.
INSERT_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
                  (-1, -1), (-1, 1), (1, -1), (1, 1))


@functools.lru_cache(maxsize=None)
def ring_offsets(ring: int):
    """(dy, dx) offsets at Chebyshev distance exactly ``ring``, row-major
    (the init tiler's spill order).  Cached: ``far_targets`` walks the same
    rings for every entry."""
    if ring == 0:
        return ((0, 0),)
    return tuple((dy, dx)
                 for dy in range(-ring, ring + 1)
                 for dx in range(-ring, ring + 1)
                 if max(abs(dy), abs(dx)) == ring)


def _entries(state: TileState, positions, radii, pids):
    """The insert's fields (x, y, px, py, radius, pid) on the state's
    device from host or device arrays; a spawn starts at rest."""
    dev = state.device
    pos = torch.as_tensor(np.asarray(positions, np.float32)).reshape(-1, 2)
    x = pos[:, 0].contiguous().to(dev)
    y = pos[:, 1].contiguous().to(dev)
    r = torch.as_tensor(np.asarray(radii, np.float32)).reshape(-1).to(dev)
    ids = torch.as_tensor(np.asarray(pids, np.int32)).reshape(-1).to(dev)
    return x, y, (x, y, x, y, r, ids)


def insert_batch(state: TileState, config: SimConfig, positions, radii,
                 pids, placed: torch.Tensor, offsets):
    """One fallback round: each (dy, dx) of ``offsets`` in turn, for every
    entry not yet ``placed`` (a bool tensor on the state's device).  Rows
    are clipped to 1..TY-2, the init tiler's spill bound: the pad rows
    above the world house storage overflow like any other tile.  Returns
    (state, placed'); num_active and overflow_count are the caller's."""
    t, TY, TX = tile_geometry(config)
    x, y, fields = _entries(state, positions, radii, pids)
    ty_t, tx_t = _tile_of(x, y, t)
    ty_t = torch.clamp(ty_t, 1, TY - 2)
    tx_t = torch.clamp(tx_t, 1, TX - 2)
    for dy, dx in offsets:
        ty_o = torch.clamp(ty_t + dy, 1, TY - 2)
        tx_o = torch.clamp(tx_t + dx, 1, TX - 2)
        state, won = _insert_compacted(state, ty_o, tx_o, fields, ~placed)
        placed = placed | won
    return state, placed


def insert_at_tiles(state: TileState, positions, radii, pids, ty_t, tx_t,
                    placed: torch.Tensor):
    """Place the entries not yet ``placed`` at the host-chosen tiles
    (ty_t, tx_t) (the far spill).  Returns (state, placed')."""
    _, _, fields = _entries(state, positions, radii, pids)
    dev = state.device
    ty_t = torch.as_tensor(np.asarray(ty_t, np.int32)).to(dev)
    tx_t = torch.as_tensor(np.asarray(tx_t, np.int32)).to(dev)
    state, won = _insert_compacted(state, ty_t, tx_t, fields, ~placed)
    return state, placed | won


def far_targets(free_counts, ty_t, tx_t, todo, ty_hi, TX):
    """Nearest tile with a free slot for each ``todo`` entry, on the host
    (numpy; the init tiler's widening ring scan).  ``free_counts`` is the
    [TY, TX] free-slot count, taken greedily in ascending entry order.
    Returns (ty, tx, found); ``found`` is False only where the whole
    interior grid is full."""
    free = np.array(free_counts, np.int64, copy=True)
    TY = free.shape[0]
    hty = np.asarray(ty_t, np.int64)
    htx = np.asarray(tx_t, np.int64)
    oty = hty.copy()
    otx = htx.copy()
    found = np.zeros(oty.shape[0], bool)
    # a full interior grid places nobody: decided in O(grid), up front
    interior_free = int(free[1:ty_hi + 1, 1:TX - 1].sum())
    if interior_free == 0:
        return oty, otx, found
    for i in np.nonzero(np.asarray(todo))[0]:
        if interior_free == 0:
            break
        dest = None
        for ring in range(0, max(TY, TX)):
            for dy, dx in ring_offsets(ring):
                sy, sx = hty[i] + dy, htx[i] + dx
                if not (1 <= sy <= ty_hi and 1 <= sx <= TX - 2):
                    continue
                if free[sy, sx] > 0:
                    dest = (sy, sx)
                    break
            if dest is not None:
                break
        if dest is None:
            continue
        free[dest] -= 1
        interior_free -= 1
        oty[i], otx[i] = dest
        found[i] = True
    return oty, otx, found


def _counted(state: TileState, placed: torch.Tensor) -> TileState:
    """num_active grows by the entries placed, overflow_count by the rest
    (one read of the count)."""
    n_placed = int(placed.sum())
    return state.replace(
        num_active=state.num_active + n_placed,
        overflow_count=state.overflow_count + (placed.shape[0] - n_placed))


def spawn_insert_into(state: TileState, config: SimConfig, positions, radii,
                      pids) -> TileState:
    """The engine's spawn insert: home and ring 1 on the device, then the
    entries still unplaced at the nearest free tiles the host finds in the
    downloaded occupancy (``far_targets``).  Only a full interior grid
    refuses an entry, counted in overflow_count."""
    n = np.asarray(radii).reshape(-1).shape[0]
    placed = torch.zeros(n, dtype=torch.bool, device=state.device)
    state, placed = insert_batch(state, config, positions, radii, pids,
                                 placed, INSERT_OFFSETS)
    if not bool(placed.all()):
        t, TY, TX = tile_geometry(config)
        ty_hi = TY - 2
        free = (state.pid < 0).sum(dim=0).cpu().numpy()
        p_np = np.asarray(positions, np.float32).reshape(-1, 2)
        hty = np.clip((p_np[:, 1] // t).astype(np.int64) + 1, 1, ty_hi)
        htx = np.clip((p_np[:, 0] // t).astype(np.int64) + 1, 1, TX - 2)
        todo = ~placed.cpu().numpy()
        ty2, tx2, found = far_targets(free, hty, htx, todo, ty_hi, TX)
        if found.any():
            # entries without a target count as placed for this call, so
            # that it skips them; only real placements are kept after
            skip = torch.as_tensor(~found).to(state.device)
            state, placed2 = insert_at_tiles(state, positions, radii, pids,
                                             ty2, tx2, placed | skip)
            placed = placed | (placed2 & ~skip)
    return _counted(state, placed)


def insert_particles(state: TileState, config: SimConfig, positions, radii,
                     pids) -> TileState:
    """Place new particles at their home tile or ring 1 around it (no far
    spill: the engine's ``spawn_insert_into`` adds it); the rest count in
    overflow_count."""
    n = np.asarray(radii).reshape(-1).shape[0]
    placed = torch.zeros(n, dtype=torch.bool, device=state.device)
    state, placed = insert_batch(state, config, positions, radii, pids,
                                 placed, INSERT_OFFSETS)
    return _counted(state, placed)


# ---------------------------------------------------------------------------
# pull relocation geometry (shared by the plain version of K2)
# ---------------------------------------------------------------------------

def step_offsets(x, y, sty, stx, *, t: float, delta: float, gTY, gTX):
    """Per-axis one-hop offsets (-1/0/+1) toward home with hysteresis: a
    particle stored in tile (sty, stx), spanning [(s-1)*t, s*t) per axis,
    moves once it is at least ``delta`` past the boundary.  Targets never
    step onto the border ring of a gTY x gTX grid (no clip when None).
    Products and sums are rounded separately, as the kernel does."""
    tf = f32(t)
    d = f32(delta)
    styf = sty.float()
    stxf = stx.float()
    dty = (y >= styf * tf + d).to(_I32) - (y < (styf - 1.0) * tf - d).to(_I32)
    dtx = (x >= stxf * tf + d).to(_I32) - (x < (stxf - 1.0) * tf - d).to(_I32)
    if gTY is not None:
        ty_t = sty + dty
        tx_t = stx + dtx
        dty = torch.where((ty_t < 1) | (ty_t > gTY - 2),
                          torch.zeros_like(dty), dty)
        dtx = torch.where((tx_t < 1) | (tx_t > gTX - 2),
                          torch.zeros_like(dtx), dtx)
    return dty, dtx


# ---------------------------------------------------------------------------
# full step
# ---------------------------------------------------------------------------

def _relocate_passes(relocate_fn, state: TileState,
                     config: SimConfig) -> TileState:
    """Run relocate_fn ``tiled_relocate_passes`` times; only the final
    pass's deferrals accumulate into overflow_count."""
    for p in range(max(1, config.tiled_relocate_passes)):
        oc = state.overflow_count
        state = relocate_fn(state, config)
        if p < config.tiled_relocate_passes - 1:
            state = state.replace(overflow_count=oc)
    return state


def _backend(choice: str, state: TileState, what: str) -> bool:
    """True = the hand-kernel route (ops/tiled_kernels), False = the
    plain tensor path the JAX package runs for ``"jnp"``.  ``"pallas"``
    asks for the kernel and therefore needs a CUDA tensor."""
    if choice == "jnp":
        return False
    if choice == "pallas" and state.device.type != "cuda":
        raise RuntimeError(
            f"{what}='pallas' asks for the CUDA kernel, but the state lies "
            f"on {state.device}")
    return True


def tiled_step_fn(state: TileState, params: StepParams, config: SimConfig,
                  do_relocate: bool = True, prm=None) -> TileState:
    """One frame: relocate (on relocating steps) -> collide -> integrate.

    Backends (config.tiled_collide / tiled_relocate):
      * "auto": the kernel wrappers (ops/tiled_kernels: K1 fused collide +
        integrate, K3 collide, K2 pull relocate; ops/gs_kernels: K5 rank
        and K6 color solve; ops/gs_parity: their parity-space forms); each
        launches its CUDA kernel for a CUDA tensor and runs its plain
        PyTorch version for a CPU tensor;
      * "pallas": the same wrappers, but a CPU tensor raises;
      * "jnp": what the JAX package runs under "jnp": separate plain
        ``collide`` (or ``gs_tiled.gs_solve``) + ``integrate``, and the
        claim ``relocate``.

    tiled_solver="gs" is the reference-exact Gauss-Seidel solve: relocate
    on every step (the config forbids a longer interval), then per
    substep the 4-color solve and the plain ``integrate``.  On the kernel
    route the solve takes the resolved gs_layout (flat K5/K6, or the
    mx/dec relayouts around K6-par); "par" runs the whole step in parity
    space instead (ops/gs_parity: K2-par, K5-par, K6-par and its Verlet
    tail), relayouting once around the step.

    ``prm`` is a ready f32[4] device vector for ``params`` at this
    substep's dt (the engine caches it); built from ``params`` if None."""
    # imported here: the kernel modules import this module
    from gpu_physics_engine_torch.ops import gs_parity, gs_tiled
    from gpu_physics_engine_torch.ops import tiled_kernels

    kernel_collide = _backend(config.tiled_collide, state, "tiled_collide")
    kernel_reloc = _backend(config.tiled_relocate, state, "tiled_relocate")
    reloc = tiled_kernels.relocate_pull if kernel_reloc else relocate
    dt_scale = 1.0 / config.substeps
    if prm is None:
        prm = params.as_tensor(state.device, dt_scale)

    if config.tiled_solver == "gs":
        if kernel_collide and gs_parity.resolve_gs_layout(
                config, state.device) == "par":
            return gs_parity.gs_parity_tile_step(state, params, config,
                                                 prm=prm)
        solve = gs_parity.gs_solve_layout if kernel_collide \
            else gs_tiled.gs_solve
        state = _relocate_passes(reloc, state, config)
        for _ in range(config.substeps):
            state = integrate(solve(state, config), params, config, prm=prm)
        return state

    if do_relocate:
        state = _relocate_passes(reloc, state, config)
    for _ in range(config.substeps):
        if not kernel_collide:
            state = integrate(collide(state, config), params, config,
                              prm=prm)
        elif config.tiled_fuse_integrate:
            state = tiled_kernels.collide_integrate(state, prm, config)
        else:
            state = integrate(tiled_kernels.collide(state, config), params,
                              config, prm=prm)
    return state
