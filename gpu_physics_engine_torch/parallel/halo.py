"""The array pipeline on a slab mesh (``gpu_physics_engine_tpu.parallel.halo``).

The world is cut into N vertical slabs, one per mesh slab
(parallel/mesh.py); each slab owns the particles whose x lies in it.  A
step, phase by phase over the slabs:

  0. every ``sort_interval_steps``, a per-slab Morton resort (it also
     compacts the pool: dead slots take the UNUSED code and sink), through
     ``ops/sort.argsort_u32(impl=config.sort_impl)``: on the card with
     "radix", the hand radix sort's kernels;
  1. **halo exchange**: the particles within ``2 * cell_size`` of a slab
     edge are packed into fixed buffers of ``halo_capacity`` and sent to
     the neighbour (``Mesh.ppermute``);
  2. **local solve** over own + halo particles: the broad phase
     (ops/grid), the stable pair sort and the 4-color solve
     (ops/collision), in global cell coordinates, so a cell straddling a
     boundary looks the same from both sides; the halo rows' corrections
     are computed and dropped;
  3. Verlet on owned particles (ops/integrate);
  4. **migration**: particles that left the slab are packed into buffers
     of ``migration_capacity``, sent, and placed in free slots.

Slots are a fixed pool with an ``alive`` mask; the buffers have fixed
sizes, and what does not fit is counted in ``dropped`` per slab.  A halo
drop loses nothing (the pair is missed for a step); a migration or
placement drop loses the particle.  Cross-boundary pairs resolve
Jacobi-style between the slabs (each applies its own half).  Like the
JAX package's module, this is the reference-dataflow prototype; the
production sharded path is parallel/tiled_shard.py.  The resort decision
reads the step counter (one host read a step); nothing else is read back.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import UNUSED_CELL_ID, SimConfig
from gpu_physics_engine_torch.core.state import ParamCache, StepParams
from gpu_physics_engine_torch.ops import collision, grid, morton
from gpu_physics_engine_torch.ops.integrate import f32, verlet_integrate
from gpu_physics_engine_torch.ops.sort import argsort_u32
from gpu_physics_engine_torch.parallel.mesh import Mesh

_I32 = torch.int32
_STATE = ("x", "y", "px", "py", "radius", "alive")


@dataclasses.dataclass
class ShardedState:
    """The particle pool, one entry per slab: x, y, px, py, radius
    [slots] f32 and alive [slots] bool on the slab's device, dropped and
    steps_since_sort i32 [1] (the JAX package's i32[n_shards] arrays, a
    row per slab)."""
    x: List[torch.Tensor]
    y: List[torch.Tensor]
    px: List[torch.Tensor]
    py: List[torch.Tensor]
    radius: List[torch.Tensor]
    alive: List[torch.Tensor]
    dropped: List[torch.Tensor]
    steps_since_sort: List[torch.Tensor]


def _pack(mask, arrays, n_slots: int):
    """Compact the masked rows into n_slots (ascending index order).
    Returns (packed arrays, valid [n_slots], packed mask, n_dropped)."""
    rank = torch.cumsum(mask, 0, dtype=_I32) - 1
    fits = mask & (rank < n_slots)
    idx = torch.where(fits, rank, n_slots).long()
    packed = []
    for a in arrays:
        buf = torch.zeros(n_slots + 1, dtype=a.dtype, device=a.device)
        buf.scatter_(0, idx, torch.where(mask, a, torch.zeros_like(a)))
        packed.append(buf[:n_slots])
    valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=mask.device)
    valid.scatter_(0, idx, fits)
    dropped = torch.sum(mask, dtype=_I32) - torch.sum(fits, dtype=_I32)
    return packed, valid[:n_slots], fits, dropped


def _place(alive, locals_, incoming, valid):
    """Write the incoming rows into free slots.  Returns (alive, arrays,
    dropped)."""
    cap = alive.shape[0]
    m = valid.shape[0]
    dev = alive.device
    free = ~alive
    frank = torch.cumsum(free, 0, dtype=_I32) - 1
    slot_idx = torch.where(free & (frank < m), frank, m).long()
    slots = torch.full((m + 1,), cap, dtype=torch.int64, device=dev)
    slots.scatter_(0, slot_idx, torch.arange(cap, dtype=torch.int64,
                                             device=dev))
    slots = slots[:m]
    placed = valid & (slots < cap)
    dest = torch.where(placed, slots, cap)  # cap: the spare slot
    out = []
    for a, inc in zip(locals_, incoming):
        buf = torch.cat([a, a.new_zeros(1)])
        buf.scatter_(0, dest, inc)
        out.append(buf[:cap])
    abuf = torch.cat([alive, alive.new_zeros(1)])
    abuf.scatter_(0, dest, torch.ones_like(valid))
    dropped = torch.sum(valid, dtype=_I32) - torch.sum(placed, dtype=_I32)
    return abuf[:cap], out, dropped


def make_sharded_step(config: SimConfig, mesh: Mesh):
    """The sharded step over ``mesh``: ShardedState, StepParams ->
    ShardedState."""
    n = mesh.size
    slab_w = config.world_width / n
    # the cell size stays the initial one (sharded runs spawn nothing)
    cs = config.min_cell_size
    margin = 2.0 * cs
    H = config.halo_capacity
    M = config.migration_capacity
    prms = {d: ParamCache(d, 1.0) for d in set(mesh.devices)}

    def resort(x, y, px, py, r, alive):
        cs_t = torch.tensor(f32(cs), dtype=torch.float32, device=x.device)
        cx, cy = grid.home_cells(x, y, cs_t)
        keys = torch.where(alive, morton.morton_encode(cx, cy),
                           UNUSED_CELL_ID)
        _, perm = argsort_u32(keys, impl=config.sort_impl)
        perm = perm.long()
        return tuple(a[perm] for a in (x, y, px, py, r, alive))

    def step(state: ShardedState, params: StepParams) -> ShardedState:
        cols = [list(getattr(state, f)) for f in _STATE]
        since = list(state.steps_since_sort)
        if config.sort_interval_steps > 0:
            dev0 = mesh.devices[0]
            due = torch.cat([s.to(dev0) for s in since]).cpu().numpy() \
                >= config.sort_interval_steps
            for i in np.nonzero(due)[0]:
                out = resort(*(c[i] for c in cols))
                for c, v in zip(cols, out):
                    c[i] = v
                since[i] = torch.zeros_like(since[i])
        x, y, px, py, r, alive = cols
        lo = [f32(i * f32(slab_w)) for i in range(n)]
        hi = [f32(v + f32(slab_w)) for v in lo]
        total = [torch.zeros((), dtype=_I32, device=d)
                 for d in mesh.devices]

        # ---- 1. halo exchange (x, y, r of the particles near an edge)
        def exchange(masks, shift):
            packs = [_pack(m, (x[i], y[i], r[i]), H)
                     for i, m in enumerate(masks)]
            for i, p in enumerate(packs):
                total[i] = total[i] + p[3]
            fields = [mesh.ppermute([p[0][k] for p in packs], shift)
                      for k in range(3)]
            return fields + [mesh.ppermute([p[1] for p in packs], shift)]

        to_left = [alive[i] & (x[i] < f32(lo[i] + f32(margin)))
                   for i in range(n)]
        to_right = [alive[i] & (x[i] >= f32(hi[i] - f32(margin)))
                    for i in range(n)]
        rxl, ryl, rrl, rvl = exchange(to_right, 1)   # from the left
        rxr, ryr, rrr, rvr = exchange(to_left, -1)   # from the right

        new = {f: [] for f in ("x", "y", "px", "py", "radius")}
        outs_l, outs_r = [], []
        for i, dev in enumerate(mesh.devices):
            cap_l = x[i].shape[0]
            cx = torch.cat([x[i], rxl[i], rxr[i]])
            cy = torch.cat([y[i], ryl[i], ryr[i]])
            cr = torch.cat([r[i], rrl[i], rrr[i]])
            calive = torch.cat([alive[i], rvl[i], rvr[i]])
            # ---- 2. broad phase + colored solve on own + halo
            cs_t = torch.tensor(f32(cs), dtype=torch.float32, device=dev)
            cand = grid.build_candidates(cx, cy, cr, calive, cs_t)
            sc, so = grid.sort_map(*grid.build_cell_ids(cand))
            table = collision.occupants_from_sorted(sc, so,
                                                    config.max_occupancy)
            sx, sy = collision.solve_colored(cx, cy, cr, table,
                                             f32(config.stiffness))
            # ---- 3. integrate the owned particles
            x2, y2, px2, py2 = verlet_integrate(
                sx[:cap_l], sy[:cap_l], px[i], py[i], r[i], alive[i],
                prms[dev](params), config)
            for f, v in zip(("x", "y", "px", "py", "radius"),
                            (x2, y2, px2, py2, r[i])):
                new[f].append(v)
            outs_l.append(alive[i] & (x2 < lo[i]))
            outs_r.append(alive[i] & (x2 >= hi[i]))

        # ---- 4. migration of the particles that left their slab
        def migrate(masks, shift):
            packs = [_pack(m, tuple(new[f][i] for f in
                                    ("x", "y", "px", "py", "radius")), M)
                     for i, m in enumerate(masks)]
            for i, p in enumerate(packs):
                total[i] = total[i] + p[3]
            sent = [mesh.ppermute([p[0][k] for p in packs], shift)
                    for k in range(5)]
            valid = mesh.ppermute([p[1] for p in packs], shift)
            return sent, valid, [p[2] for p in packs]

        inc_l, vl, fit_l = migrate(outs_r, 1)
        inc_r, vr, fit_r = migrate(outs_l, -1)
        out = {f: [] for f in _STATE}
        for i in range(n):
            alive2 = alive[i] & ~(fit_l[i] | fit_r[i])
            locals_ = [new[f][i] for f in ("x", "y", "px", "py", "radius")]
            alive2, locals_, d5 = _place(alive2, locals_,
                                         [s[i] for s in inc_l], vl[i])
            alive2, locals_, d6 = _place(alive2, locals_,
                                         [s[i] for s in inc_r], vr[i])
            total[i] = total[i] + d5 + d6
            for f, v in zip(_STATE, locals_ + [alive2]):
                out[f].append(v)
        return ShardedState(
            **out,
            dropped=[d + t.view(1) for d, t in zip(state.dropped, total)],
            steps_since_sort=[s + 1 for s in since])

    return step


def init_sharded(config: SimConfig, mesh: Mesh, positions, radii,
                 slots_per_shard: int) -> ShardedState:
    """Give each particle to the slab its x lies in (host side, at
    init); each slab's first ``slots_per_shard`` owners are kept."""
    n = mesh.size
    slab_w = config.world_width / n
    positions = np.asarray(positions, np.float32).reshape(-1, 2)
    radii = np.asarray(radii, np.float32).reshape(-1)
    owner = np.clip((positions[:, 0] // slab_w).astype(np.int64), 0, n - 1)
    cols = {f: [] for f in _STATE}
    for s, dev in enumerate(mesh.devices):
        mine = np.nonzero(owner == s)[0][:slots_per_shard]
        k = len(mine)
        vals = {"x": positions[mine, 0], "y": positions[mine, 1],
                "radius": radii[mine]}
        for f in ("x", "y", "radius"):
            a = np.zeros(slots_per_shard, np.float32)
            a[:k] = vals[f]
            cols[f].append(torch.from_numpy(a).to(dev))
        cols["px"].append(cols["x"][-1].clone())
        cols["py"].append(cols["y"][-1].clone())
        alive = np.zeros(slots_per_shard, bool)
        alive[:k] = True
        cols["alive"].append(torch.from_numpy(alive).to(dev))
    zeros = [torch.zeros(1, dtype=_I32, device=d) for d in mesh.devices]
    return ShardedState(**cols, dropped=zeros,
                        steps_since_sort=[z.clone() for z in zeros])


def gather(state: ShardedState, field: str) -> np.ndarray:
    """One field of every slab, concatenated on the host (the JAX
    package's [n_shards * slots] array)."""
    return np.concatenate([a.cpu().numpy() for a in getattr(state, field)])


def gather_alive(state: ShardedState):
    """Host download of the live particles (positions, radii)."""
    alive = gather(state, "alive")
    pos = np.stack([gather(state, "x"), gather(state, "y")], -1)
    return pos[alive], gather(state, "radius")[alive]

