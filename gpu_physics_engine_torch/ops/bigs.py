"""Big-particle overlay (``gpu_physics_engine_tpu.ops.bigs``): spawned
particles too large for the tile geometry, kept beside the tiles.

The reference answers a spawn of radius 1-3 particles by growing its cell
to 2.2 x the largest radius and rebuilding its grid.  Re-tiling a
production scene for one burst would blow up the tile area and the slot
capacity, so the tiles keep their geometry and the few large particles
live in a dense side array, ``BigState`` ([B] per field), coupled to the
tiles once a step:

  * big-big: all pairs of the [B] arrays;
  * big-small: each big gathers the [cap, 2W+1, 2W+1] tile window around
    its home tile (W from the config, ``window_halfwidth``), takes the
    pair correction against every occupant, sums its own share, and
    scatters each partner's share back into its slot.

Corrections are Jacobi (from frozen positions) with the reference's
inverse-mass split, through ``gs_tiled.pair_correction``.  Plain PyTorch:
the JAX package leaves these stages to XLA (no ``pallas_call``).

Sums run in a fixed order on every device, with no atomics: a pairwise
tree over each big's terms, and the partners' shares added to each slot
in update order, as the JAX package's scatter adds them.  The pass is
therefore deterministic, and the card's results equal the CPU's bit for
bit.  XLA reduces each big's terms in its own order, so a big with three
or more partners may differ from the JAX package's by f32 rounding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.state import StepParams
from gpu_physics_engine_torch.ops.gs_tiled import pair_correction
from gpu_physics_engine_torch.ops.integrate import f32, verlet_integrate
from gpu_physics_engine_torch.ops.tiled import (TileState, _group_rank,
                                                tile_geometry, tiled_step_fn)

_I32 = torch.int32
FIELDS = ("x", "y", "px", "py", "radius", "pid")


@dataclasses.dataclass
class BigState:
    """Dense overlay state: [B] f32 fields, an i32 ``pid`` (-1 marks an
    empty slot) and an i32 0-d ``num_active``, all on one device."""
    x: torch.Tensor
    y: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    radius: torch.Tensor
    pid: torch.Tensor
    num_active: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def occupied(self) -> torch.Tensor:
        return self.pid >= 0

    def replace(self, **kw) -> "BigState":
        return dataclasses.replace(self, **kw)


def init_bigs(capacity: int, device=None) -> BigState:
    device = torch.device(device or "cpu")

    def z():
        return torch.zeros(capacity, dtype=torch.float32, device=device)

    return BigState(x=z(), y=z(), px=z(), py=z(), radius=z(),
                    pid=torch.full((capacity,), -1, dtype=_I32,
                                   device=device),
                    num_active=torch.zeros((), dtype=_I32, device=device))


def grow_bigs(big: BigState, capacity: int) -> BigState:
    """``big`` with empty slots appended up to ``capacity``."""
    pad = capacity - big.capacity
    return big.replace(**{
        f: torch.nn.functional.pad(getattr(big, f), (0, pad),
                                   value=-1 if f == "pid" else 0.0)
        for f in FIELDS})


def to_numpy(big: BigState) -> Dict[str, np.ndarray]:
    """Host copy of every field, keyed by the BigState field names (the
    JAX package's BigState carries the same keys)."""
    return {f.name: getattr(big, f.name).cpu().numpy()
            for f in dataclasses.fields(BigState)}


def from_numpy(arrays: Dict[str, np.ndarray], device=None) -> BigState:
    """BigState from host arrays keyed like ``to_numpy``'s output (also
    ``{f: np.asarray(getattr(jax_big, f))}`` of a JAX BigState)."""
    device = torch.device(device or "cpu")

    def t(name, dtype):
        return torch.from_numpy(np.array(arrays[name], dtype)).to(device)

    return BigState(
        x=t("x", np.float32), y=t("y", np.float32),
        px=t("px", np.float32), py=t("py", np.float32),
        radius=t("radius", np.float32), pid=t("pid", np.int32),
        num_active=t("num_active", np.int32).reshape(()))


def window_halfwidth(config: SimConfig) -> int:
    """Half-width W of the tile window so that every possible big-small
    pair is inside the gather: bigs reach spawn_radius_max, partners
    r_small plus the pull relocate's staleness band past their storage
    tile (hysteresis and the relocate interval's off-step drift).  A
    window that would wrap round the grid raises instead of shrinking."""
    t, TY, TX = tile_geometry(config)
    reach = (config.spawn_radius_max + config.tile_max_radius_effective
             + config.hysteresis_delta
             + (config.tiled_relocate_interval - 1) * config.drift_budget)
    w = int(math.ceil(reach / t))
    # a wrapped window would visit a tile twice and count its pairs twice
    w_max = (min(TY, TX) - 1) // 2
    clamped = max(1, min(w, w_max))
    if clamped < w and not (2 * clamped + 1 >= TY
                            and 2 * clamped + 1 >= TX):
        # a smaller window would skip real pairs without a counter seeing it
        raise ValueError(
            f"grid ({TY}x{TX} tiles, edge {t:.3g}) is too small for the "
            f"big-particle gather window (need half-width {w}, max "
            f"{clamped} without wrapping); use tiled_spawn='retile' or "
            "a larger world for oversized spawns at this scale")
    return clamped


def _pair(dx, dy, ri, rj, stiffness: float):
    """Pair corrections for a separation (dx, dy), through the one pair
    formula (``gs_tiled.pair_correction``): (dxi, dyi, dxj, dyj, hit);
    i moves by +(dxi, dyi), j by -(dxj, dyj)."""
    return pair_correction(dx, dy, ri, 0.0, 0.0, rj, stiffness)


def _tree_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order (zero-padded to a
    power of two), so that every device rounds alike."""
    n = a.shape[-1]
    p = 1 << max(0, n - 1).bit_length()
    if p != n:
        a = torch.nn.functional.pad(a, (0, p - n))
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    return a[..., 0]


def _scatter_add(planes, key: torch.Tensor, upd: torch.Tensor):
    """``planes`` (P flat [S] planes) plus ``upd`` [P, N] at the slots
    ``key`` [N] (S = no slot), added in update order as a sequential
    scatter-add does: a stable sort groups each slot's entries in update
    order, then one pass per rank within a slot adds them (one read of the
    largest rank).  No atomics, so every device adds alike.  Returns the
    new planes, views of one [P, S + 1] buffer (column S absorbs the
    entries without a slot)."""
    P, S = len(planes), planes[0].shape[0]
    key, perm = torch.sort(key, stable=True)
    rank = _group_rank(key)
    live = key < S
    levels = int(torch.where(live, rank, -1).max()) + 1
    # the planes' entries side by side in one buffer: plane p at p * (S + 1)
    base = torch.arange(P, dtype=key.dtype, device=key.device) * (S + 1)
    keys = (key + base[:, None]).reshape(-1)
    dummy = (S + base[:, None]).expand(P, key.shape[0]).reshape(-1)
    rank, live = rank.repeat(P), live.repeat(P)
    vals = upd[:, perm].reshape(-1)
    z = planes[0].new_zeros(1)
    buf = torch.cat([t for p in planes for t in (p, z)])
    for r in range(levels):
        dst = torch.where(live & (rank == r), keys, dummy)
        buf.index_put_((dst,), buf[dst] + vals)
    buf = buf.view(P, S + 1)
    return [buf[p, :S] for p in range(P)]


def couple_bigs(tiles: TileState, big: BigState,
                config: SimConfig) -> Tuple[TileState, BigState]:
    """One Jacobi coupling pass: big-big and big-small positional
    corrections from frozen positions.  Returns new (tiles, big); the
    inputs are not modified."""
    stiffness = f32(config.stiffness)
    dev = big.device
    bocc = big.occupied()
    bx, by, br = big.x, big.y, big.radius
    B = big.capacity
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    # ---- big-big: all pairs of the [B] arrays ----
    cxi, cyi, _, _, hit = _pair(bx[:, None] - bx[None, :],
                                by[:, None] - by[None, :],
                                br[:, None], br[None, :], stiffness)
    valid = (hit & bocc[:, None] & bocc[None, :]
             & ~torch.eye(B, dtype=torch.bool, device=dev))

    # ---- big-small: each big's [cap, win, win] tile window ----
    t, TY, TX = tile_geometry(config)
    cap = tiles.dims[0]
    S = cap * TY * TX
    if 2 * (S + 1) > 2 ** 31 - 1:  # _scatter_add's x and y buffer
        raise ValueError(f"{S} tile slots do not fit int32 slot indices")
    W = window_halfwidth(config)
    win = 2 * W + 1
    tf = torch.tensor(f32(t), dtype=torch.float32, device=dev)
    sy = torch.clamp(torch.floor(by / tf).to(_I32) + 1 - W, 0, TY - win)
    sx = torch.clamp(torch.floor(bx / tf).to(_I32) + 1 - W, 0, TX - win)
    off = torch.arange(win, dtype=_I32, device=dev)
    k = torch.arange(cap, dtype=_I32, device=dev) * (TY * TX)
    flat = (k.view(1, cap, 1, 1)
            + ((sy[:, None] + off) * TX).view(B, 1, win, 1)
            + (sx[:, None] + off).view(B, 1, 1, win))

    def gather(plane):
        return plane.reshape(-1)[flat]

    gp = gather(tiles.pid)
    sxi, syi, sxj, syj, shit = _pair(
        bx.view(B, 1, 1, 1) - gather(tiles.x),
        by.view(B, 1, 1, 1) - gather(tiles.y),
        br.view(B, 1, 1, 1), gather(tiles.radius), stiffness)
    svalid = shit & bocc.view(B, 1, 1, 1) & (gp >= 0)

    # each big's own share: its big-big terms, then its window's, in one
    # fixed tree
    terms = torch.cat([torch.stack([torch.where(valid, cxi, zero),
                                    torch.where(valid, cyi, zero)]),
                       torch.stack([torch.where(svalid, sxi, zero),
                                    torch.where(svalid, syi, zero)])
                       .reshape(2, B, -1)], 2)
    dbx, dby = _tree_sum(terms)

    # ---- the partners' shares, back into their slots ----
    key = torch.where(svalid, flat, S).reshape(-1)
    upd = torch.stack([torch.where(svalid, -sxj, zero),
                       torch.where(svalid, -syj, zero)]).reshape(2, -1)
    nx, ny = _scatter_add((tiles.x.reshape(-1), tiles.y.reshape(-1)), key,
                          upd)
    tiles = tiles.replace(x=nx.view(tiles.dims), y=ny.view(tiles.dims))
    big = big.replace(x=torch.where(bocc, bx + dbx, bx),
                      y=torch.where(bocc, by + dby, by))
    return tiles, big


def integrate_bigs(big: BigState, params: StepParams, config: SimConfig,
                   dt_scale: float = 1.0, prm=None) -> BigState:
    """Verlet with gravity, the mouse attractor and the world constraint on
    the overlay: the tiles' equation (``integrate.verlet_integrate``).
    ``prm`` is a ready f32[4] device vector for ``params`` at ``dt_scale``
    (built if None)."""
    if prm is None:
        prm = params.as_tensor(big.device, dt_scale)
    nx, ny, npx, npy = verlet_integrate(big.x, big.y, big.px, big.py,
                                        big.radius, big.occupied(), prm,
                                        config)
    return big.replace(x=nx, y=ny, px=npx, py=npy)


def hybrid_step_fn(tiles: TileState, big: BigState, params: StepParams,
                   config: SimConfig, do_relocate: bool = True, prm=None
                   ) -> Tuple[TileState, BigState]:
    """A frame with the overlay: the coupling pass, then the tiles' step
    (``tiled_step_fn``: relocate on relocating steps, collide, integrate),
    then the bigs' Verlet once a substep.  The coupling runs once a frame
    whatever the substeps.  ``prm`` as in ``tiled_step_fn``: the f32[4]
    vector at dt / substeps (built if None)."""
    if prm is None:
        prm = params.as_tensor(tiles.device, 1.0 / config.substeps)
    tiles, big = couple_bigs(tiles, big, config)
    tiles = tiled_step_fn(tiles, params, config, do_relocate=do_relocate,
                          prm=prm)
    for _ in range(config.substeps):
        big = integrate_bigs(big, params, config, prm=prm)
    return tiles, big


def export_bigs(big: BigState):
    """Host download of the live overlay particles: (pid, positions,
    previous positions, radii), by ascending pid."""
    a = to_numpy(big)
    live = a["pid"] >= 0
    pid = a["pid"][live]
    order = np.argsort(pid, kind="stable")
    pos = np.stack([a["x"][live], a["y"][live]], -1)
    prev = np.stack([a["px"][live], a["py"][live]], -1)
    return pid[order], pos[order], prev[order], a["radius"][live][order]
