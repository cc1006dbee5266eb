"""The tiled pipeline on a slab mesh
(``gpu_physics_engine_tpu.parallel.tiled_shard``).

The tile grid is cut into horizontal slabs of ``rows`` tile rows, one per
mesh slab (parallel/mesh.py).  Because storage IS the spatial structure,
the exchanges are fixed-shape tile rows:

  1. **Collision halo**: each slab sends its first and last tile row (x,
     y, radius and occupancy, [cap, 1, TX] each) to its neighbours,
     joins the rows it receives above and below its own, runs the same
     collide kernel on the extended [cap, rows + 2, TX] slab (K1 fused
     with Verlet, or K3 and then ``integrate``) and keeps the middle.  The
     extended pid plane is 0 where a slot is occupied and -1 where it is
     not: the sweep reads pid only as occupancy and excludes self by slot,
     so no real pid crosses in the halo.
  2. **Integration**: local.
  3. **Relocation**: on the kernel route, the one-hop crossers of a slab
     boundary (found with the pull relocate's own step offsets) are
     shipped with a two-phase commit, then K2 relocates inside the slab at
     its global row offset (``row0 = slab * rows``, ``global_rows =
     TYp``); on the claim route (and in the periodic sweep) the local
     movers claim slots in the slab, then the crossers ship.  Shipping:
     the sender packs copies into fixed per-direction buffers, the
     receiver claims slots and returns its placed mask, the sender
     vacates only the confirmed slots.  A full buffer or a full receiving
     tile defers the mover (it stays and retries), counted per slab:
     nothing is lost.

The global grid keeps its empty border ring, and the rows that pad TY to
a multiple of the slab count sit above the world and stay empty; slab
0's top halo and the last slab's bottom halo are the mesh edge's zeros.

The step runs eagerly, phase by phase over the slabs, and never reads a
value back to the host: the compactions are cumsum ranks scattered into
fixed buffers (``tiled._nonzero_padded``) and the claims write to a spare
slot (``tiled._insert_compacted``).  Unlike ``TiledEngine``, which
relocates first, a step collides, integrates and then relocates, as the
JAX package's sharded step does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.state import ParamCache, StepParams
from gpu_physics_engine_torch.ops import tiled
from gpu_physics_engine_torch.ops.tiled import TileState, _iota, _tile_of
from gpu_physics_engine_torch.ops.tiled_kernels import check_card_cap
from gpu_physics_engine_torch.parallel.mesh import (Mesh, gather_tiles,
                                                    make_mesh, shard_tiles)
from gpu_physics_engine_torch.utils.timer import FrameTimer

_I32 = torch.int32

Slabs = List[TileState]


def sharded_tile_geometry(config: SimConfig, n_shards: int):
    """(tile_edge, TY_padded, TX, rows_per_shard).  TY is padded so every
    slab owns the same number of rows; the pad rows sit above the world
    and stay empty."""
    t, TY, TX = tiled.tile_geometry(config)
    rows = int(math.ceil(TY / n_shards))
    return t, rows * n_shards, TX, rows


def init_sharded_tiles(config: SimConfig, mesh: Mesh, positions, radii,
                       pids=None, previous_positions=None) -> Slabs:
    """The host tiler's layout (``tiled.init_tiles``), padded with empty
    rows (pid -1) to the sharded height and cut into the mesh's slabs.
    ``pids`` / ``previous_positions`` resume an exported particle set."""
    _, TYp, TX, _ = sharded_tile_geometry(config, mesh.size)
    st = tiled.init_tiles(config, positions, radii, pids=pids,
                          previous_positions=previous_positions)
    pad = TYp - st.dims[1]
    if pad:
        cap = st.dims[0]
        planes = {}
        for f in tiled.FIELDS:
            a = getattr(st, f)
            fill = torch.full((cap, pad, TX), -1 if f == "pid" else 0,
                              dtype=a.dtype)
            planes[f] = torch.cat([a, fill], dim=1)
        st = st.replace(**planes)
    return shard_tiles(st, mesh)


def with_counters(slabs: Sequence[TileState], num_active=None,
                  overflow_count=None) -> Slabs:
    """The slabs with new replicated counters (None keeps the old)."""
    na = slabs[0].num_active if num_active is None else num_active
    oc = slabs[0].overflow_count if overflow_count is None \
        else overflow_count
    return [s.replace(num_active=na, overflow_count=oc) for s in slabs]


def _pack(state: TileState, mask: torch.Tensor, extra, size: int):
    """Compact the masked slots of ``state`` into [size] buffers
    (ascending slot order): (idx, live, fields, extras, n_mask), where
    fields = (x, y, px, py, radius, pid) with 0 / -1 past the live ones."""
    fm = mask.reshape(-1)
    flat_size = fm.shape[0]
    idx = tiled._nonzero_padded(fm, size, flat_size)
    live = idx < flat_size
    idx = torch.where(live, idx, torch.zeros_like(idx))

    def take(a, fill):
        v = a.reshape(-1)[idx]
        return torch.where(live, v, torch.full_like(v, fill))

    fields = (take(state.x, 0.0), take(state.y, 0.0), take(state.px, 0.0),
              take(state.py, 0.0), take(state.radius, 0.0),
              take(state.pid, -1))
    extras = tuple(take(e.expand(state.dims), 0) for e in extra)
    return idx, live, fields, extras, torch.sum(fm, dtype=_I32)


def _halo_rows(mesh: Mesh, planes) -> List[torch.Tensor]:
    """Each slab's plane with the row from the slab above joined before it
    and the row from the slab below after it: [cap, rows + 2, TX].  The
    mesh edges get zeros (vacant: occupancy travels as its own plane,
    never as pid)."""
    from_below = mesh.ppermute([p[:, :1] for p in planes], -1)
    from_above = mesh.ppermute([p[:, -1:] for p in planes], 1)
    return [torch.cat([a, p, b], dim=1) for a, p, b in
            zip(from_above, planes, from_below)]


def extended_slabs(mesh: Mesh, slabs: Sequence[TileState],
                   fused: bool) -> Slabs:
    """The halo-extended slabs that the collide kernels run on: x, y and
    radius with the neighbours' edge rows, pid 0 where a slot is occupied
    and -1 where not (occupancy only).  ``fused`` (K1): px and py get zero
    halo rows, whose Verlet output is cut away; else (K3, the plain
    collide) px and py are x and y."""
    ex = _halo_rows(mesh, [s.x for s in slabs])
    ey = _halo_rows(mesh, [s.y for s in slabs])
    er = _halo_rows(mesh, [s.radius for s in slabs])
    eocc = _halo_rows(mesh, [s.pid >= 0 for s in slabs])
    out = []
    for i, s in enumerate(slabs):
        epid = eocc[i].to(_I32) - 1  # 0 occupied, -1 vacant
        if fused:
            zrow = torch.zeros_like(s.px[:, :1])
            px = torch.cat([zrow, s.px, zrow], dim=1)
            py = torch.cat([zrow, s.py, zrow], dim=1)
        else:
            px, py = ex[i], ey[i]
        out.append(s.replace(x=ex[i], y=ey[i], px=px, py=py, radius=er[i],
                             pid=epid))
    return out


def _middle(a: torch.Tensor) -> torch.Tensor:
    """An extended slab's own rows."""
    return a[:, 1:-1].contiguous()


def _check_supported(config: SimConfig) -> None:
    if config.tiled_solver != "sweep":
        raise ValueError(
            f"tiled_solver={config.tiled_solver!r} is single-chip only "
            "(the GS parity solver needs storage == home every step); "
            "the sharded step runs the production Jacobi sweep")
    if config.tiled_relocate_passes != 1:
        raise ValueError(
            "tiled_relocate_passes > 1 is not implemented on the "
            "sharded step (single-chip only)")


def make_sharded_tiled_step_fn(config: SimConfig, mesh: Mesh,
                               do_relocate: bool = True,
                               relocate_only: bool = False):
    """``step_fn(slabs, params) -> (slabs, per_slab_drop i32[n] on
    mesh.devices[0])``.

    ``do_relocate=False`` is the off-step of tiled_relocate_interval: the
    halo, collide and integrate only; relocation and the crossers'
    migration are skipped together (both move storage only).
    ``relocate_only=True`` is the periodic exact sweep: no physics, the
    claim relocate in each slab and one slab hop of migration.

    Backends follow ``tiled._backend``: "auto" and "pallas" run the kernel
    wrappers (K1 or K3, K2; their plain versions for CPU tensors), "jnp"
    the plain ``collide`` + ``integrate`` and the claim relocate."""
    from gpu_physics_engine_torch.ops import tiled_kernels

    assert not (relocate_only and not do_relocate)
    _check_supported(config)
    n = mesh.size
    t, TYp, TX, rows = sharded_tile_geometry(config, n)
    m_cap = config.migration_capacity
    dev0 = mesh.devices[0]
    prms = {d: ParamCache(d, 1.0 / config.substeps)
            for d in set(mesh.devices)}

    def collide_all(local: Slabs, params: StepParams, kernel: bool) -> Slabs:
        fused = kernel and config.tiled_fuse_integrate
        out = []
        for s, ext in zip(local, extended_slabs(mesh, local, fused)):
            prm = prms[s.device](params)
            if fused:
                solved = tiled_kernels.collide_integrate(ext, prm, config)
                out.append(s.replace(x=_middle(solved.x),
                                     y=_middle(solved.y),
                                     px=_middle(solved.px),
                                     py=_middle(solved.py)))
                continue
            solved = (tiled_kernels.collide(ext, config) if kernel
                      else tiled.collide(ext, config))
            s = s.replace(x=_middle(solved.x), y=_middle(solved.y))
            out.append(tiled.integrate(s, params, config, prm=prm))
        return out

    def ship_crossers(local: Slabs, go_up, go_dn, tx_target, drops):
        """Ship slab-boundary crossers up, then down, each with a
        two-phase commit: copies go over, the receiver claims slots and
        returns its placed mask, the sender vacates only what was
        confirmed.  A crosser that did not fit in the buffer, or whose
        receiving tile is full, stays and counts in ``drops``."""
        for masks, shift, into_row in ((go_up, -1, rows - 1),
                                       (go_dn, 1, 0)):
            packs = [_pack(s, m, (tx,), m_cap)
                     for s, m, tx in zip(local, masks, tx_target)]
            for i, (_, live, _, _, n_mask) in enumerate(packs):
                drops[i] = drops[i] + n_mask - torch.sum(live, dtype=_I32)
            sent = [mesh.ppermute([p[2][k] for p in packs], shift)
                    for k in range(6)]
            rtx = mesh.ppermute([p[3][0] for p in packs], shift)
            rlive = mesh.ppermute([p[1] for p in packs], shift)
            placed = []
            for i, s in enumerate(local):
                rty = torch.full((m_cap,), into_row, dtype=_I32,
                                 device=s.device)
                tx_in = torch.where(rlive[i], rtx[i],
                                    torch.zeros_like(rtx[i]))
                local[i], won = tiled._insert_compacted(
                    s, rty, tx_in, tuple(sent[k][i] for k in range(6)),
                    rlive[i])
                placed.append(won)
            confirm = mesh.ppermute(placed, -shift)
            for i, (idx, live, _, _, _) in enumerate(packs):
                ok = live & confirm[i]
                local[i] = tiled.vacate(local[i], idx, ok)
                drops[i] = drops[i] + torch.sum(live & ~confirm[i],
                                                dtype=_I32)
        return local

    def relocate_all(local: Slabs, kernel: bool, drops) -> Slabs:
        if kernel:
            # the crossers by K2's own step offsets, so shipping and the
            # in-slab relocate agree on who moves
            go_up, go_dn, tx_t = [], [], []
            for i, s in enumerate(local):
                ty_now = _iota(s.dims, 1, s.device)
                tx_now = _iota(s.dims, 2, s.device)
                dty, dtx = tiled.step_offsets(
                    s.x, s.y, ty_now + i * rows, tx_now, t=t,
                    delta=config.hysteresis_delta, gTY=TYp, gTX=TX)
                occ = s.pid >= 0
                go_up.append(occ & (ty_now == 0) & (dty < 0))
                go_dn.append(occ & (ty_now == rows - 1) & (dty > 0))
                tx_t.append(tx_now + dtx)
            local = ship_crossers(local, go_up, go_dn, tx_t, drops)
            for i, s in enumerate(local):
                zero = torch.zeros((), dtype=_I32, device=s.device)
                moved = tiled_kernels.relocate_pull(
                    s.replace(overflow_count=zero), config, row0=i * rows,
                    global_rows=TYp)
                drops[i] = drops[i] + moved.overflow_count
                local[i] = moved.replace(overflow_count=s.overflow_count)
            return local
        go_up, go_dn, tx_t = [], [], []
        for i, s in enumerate(local):
            occ = s.pid >= 0
            ty_now = _iota(s.dims, 1, s.device)
            tx_now = _iota(s.dims, 2, s.device)
            ty_want, tx_want = _tile_of(s.x, s.y, t)
            ty_want = torch.clamp(ty_want, 1, TYp - 2) - i * rows
            tx_want = torch.clamp(tx_want, 1, TX - 2)
            mover = occ & ((ty_want != ty_now) | (tx_want != tx_now))
            stays = (ty_want >= 0) & (ty_want < rows)
            go_up.append(mover & (ty_want < 0))
            go_dn.append(mover & (ty_want >= rows))
            tx_t.append(tx_want)
            # local movers first, in slots of the slab.  The sweep's
            # buffer scales with the slab population, as the single-chip
            # sweep's does with the particle count.
            if relocate_only:
                slab_slots = s.dims[0] * rows * TX
                l_cap = config.sweep_mover_capacity or max(
                    config.mover_capacity, slab_slots // 32)
            else:
                l_cap = config.mover_capacity
            idx, live, fields, (tyl, txl), n_local = _pack(
                s, mover & stays, (torch.clamp(ty_want, 0, rows - 1),
                                   tx_want), l_cap)
            drops[i] = drops[i] + n_local - torch.sum(live, dtype=_I32)
            s, placed = tiled._insert_compacted(s, tyl, txl, fields, live)
            local[i] = tiled.vacate(s, idx, placed)
        return ship_crossers(local, go_up, go_dn, tx_t, drops)

    def step_fn(slabs: Sequence[TileState], params: StepParams
                ) -> Tuple[Slabs, torch.Tensor]:
        kernel_collide = tiled._backend(config.tiled_collide, slabs[0],
                                        "tiled_collide")
        kernel_reloc = tiled._backend(config.tiled_relocate, slabs[0],
                                      "tiled_relocate")
        dropped = slabs[0].overflow_count
        local = list(slabs)
        for _ in range(0 if relocate_only else config.substeps):
            local = collide_all(local, params, kernel_collide)
        drops = [torch.zeros((), dtype=_I32, device=s.device)
                 for s in local]
        if do_relocate:
            local = relocate_all(local, kernel_reloc and not relocate_only,
                                 drops)
        alive = mesh.psum([torch.sum(s.pid >= 0, dtype=_I32)
                           for s in local])[0]
        per_slab = torch.stack([d.to(dev0) for d in drops])
        dropped = dropped + torch.sum(per_slab, dtype=_I32)
        return with_counters(local, alive, dropped), per_slab

    return step_fn


def _entries_on(slabs: Sequence[TileState], positions, radii, pids):
    """The insert's fields on each slab's device (one copy a device)."""
    cache = {}
    for s in slabs:
        if s.device not in cache:
            cache[s.device] = tiled._entries(s, positions, radii, pids)
    return [cache[s.device] for s in slabs]


def make_sharded_insert(config: SimConfig, mesh: Mesh,
                        offsets=tiled.INSERT_OFFSETS):
    """One spawn-insert round on the slabs: every slab sees the whole
    burst and inserts the entries whose target row lies in it.  The
    offsets run in a fixed order with the placed mask OR-reduced across
    the slabs after each, so an entry whose fallback tile lies in another
    slab than its home tile is placed once.  Fallback rows clip to the
    real interior rows (``tile_geometry(config)[1] - 2``): the slab pad
    rows above them stay vacant.  ``insert(slabs, positions, radii, pids,
    placed) -> (slabs, placed)``, ``placed`` a bool tensor on
    mesh.devices[0]; the counters are the caller's."""
    _, _, TX, rows = sharded_tile_geometry(config, mesh.size)
    t = tiled.tile_geometry(config)[0]
    ty_hi = tiled.tile_geometry(config)[1] - 2

    def insert(slabs, positions, radii, pids, placed):
        local = list(slabs)
        entries = _entries_on(local, positions, radii, pids)
        homes = []
        for x, y, _ in entries:
            ty_g, tx_t = _tile_of(x, y, t)
            homes.append((torch.clamp(ty_g, 1, ty_hi),
                          torch.clamp(tx_t, 1, TX - 2)))
        placed = [placed.to(s.device) for s in local]
        for dy, dx in offsets:
            won = []
            for i, s in enumerate(local):
                ty_g, tx_t = homes[i]
                ty_l = torch.clamp(ty_g + dy, 1, ty_hi) - i * rows
                tx_o = torch.clamp(tx_t + dx, 1, TX - 2)
                mine = ~placed[i] & (ty_l >= 0) & (ty_l < rows)
                local[i], w = tiled._insert_compacted(
                    s, torch.clamp(ty_l, 0, rows - 1), tx_o, entries[i][2],
                    mine)
                won.append(w)
            placed = [p > 0 for p in mesh.psum(
                [(p | w).to(_I32) for p, w in zip(placed, won)])]
        return local, placed[0]

    return insert


def make_sharded_place_at(config: SimConfig, mesh: Mesh):
    """The far spill at host-chosen global target tiles (ty_t, tx_t): the
    slab owning a target row inserts, and the placed mask is OR-reduced
    across the slabs.  ``place(slabs, positions, radii, pids, ty_t, tx_t,
    placed) -> (slabs, placed)``."""
    rows = sharded_tile_geometry(config, mesh.size)[3]

    def place(slabs, positions, radii, pids, ty_t, tx_t, placed):
        local = list(slabs)
        entries = _entries_on(local, positions, radii, pids)
        won = []
        for i, s in enumerate(local):
            ty = torch.as_tensor(np.asarray(ty_t, np.int32)).to(s.device)
            tx = torch.as_tensor(np.asarray(tx_t, np.int32)).to(s.device)
            ty_l = ty - i * rows
            p = placed.to(s.device)
            mine = ~p & (ty_l >= 0) & (ty_l < rows)
            local[i], w = tiled._insert_compacted(
                s, torch.clamp(ty_l, 0, rows - 1), tx, entries[i][2], mine)
            won.append(p | w)
        return local, mesh.psum([w.to(_I32) for w in won])[0] > 0

    return place


class ShardedTiledEngine:
    """The TiledEngine API (run, step, the mouse, spawns, downloads,
    checkpoints) over the sharded tiled pipeline on a slab mesh.  The
    engine runs on the CUDA cards (``make_mesh()``) unless the caller
    passes a mesh; ``self.state`` is the list of slabs."""

    CHUNK = 16  # steps per run() window

    def __init__(self, config: SimConfig, mesh: Optional[Mesh] = None,
                 seed: int = 0, initial_arrays=None):
        """``initial_arrays`` = (positions, radii, pids, previous) resumes
        an exported particle set (see from_checkpoint) instead of the
        uniform random scene drawn from ``seed``."""
        from gpu_physics_engine_torch.core.tiled_engine import _auto_cap

        if config.tiled_sweep in ("rebuild", "bands"):
            # the rebuild is a global stable re-slot and a band may
            # straddle a slab boundary: the claim sweep with the two-phase
            # migration is the sharded engine's storage repair
            raise ValueError(
                f"tiled_sweep={config.tiled_sweep!r} is single-chip "
                "only: the sharded engine's periodic exact sweep is "
                "the slab claim sweep (set tiled_sweep='relocate' or "
                "run single-chip)")
        if config.tiled_rebuild_every:
            raise ValueError(
                "tiled_rebuild_every is single-chip only (the hybrid's "
                "k-th sweep is the global rebuild; see the "
                "tiled_sweep='rebuild' exclusion)")
        self.mesh = mesh if mesh is not None else make_mesh()
        self.device = self.mesh.devices[0]
        self._gen = torch.Generator().manual_seed(int(seed))
        pids = prev = None
        if initial_arrays is not None:
            positions, radii, pids, prev = initial_arrays
            positions = np.asarray(positions, np.float32).reshape(-1, 2)
            radii = np.asarray(radii, np.float32).reshape(-1)
            n = len(positions)
        else:
            n = config.initial_particles
            u = torch.rand((2, n), generator=self._gen, dtype=torch.float32)
            positions = np.stack([
                u[0].numpy() * np.float32(config.world_width),
                u[1].numpy() * np.float32(config.world_height)], -1)
            radii = np.full(n, config.initial_radius, np.float32)
        if config.tile_cap == 0:
            config = config.replace(tile_cap=_auto_cap(config, positions))
        _, _, TX, rows = sharded_tile_geometry(config, self.mesh.size)
        for d in self.mesh.devices:  # a halo-extended slab a device
            check_card_cap(config.tile_cap, d, (rows + 2) * TX)
        if (config.tiled_uniform_radius
                and not np.all(radii == np.float32(config.initial_radius))):
            print("[tiled] mixed radii in initial arrays: disabling "
                  "tiled_uniform_radius")
            config = config.replace(tiled_uniform_radius=False)
        self.config = config
        self.state = init_sharded_tiles(config, self.mesh, positions, radii,
                                        pids=pids, previous_positions=prev)
        self._build()
        self._steps_done = 0
        self._next_pid = (int(np.max(pids)) + 1 if pids is not None
                          and len(np.asarray(pids)) else n)
        # cumulative deferrals per slab, accumulated on the device
        self._drops_dev = torch.zeros(self.mesh.size, dtype=_I32,
                                      device=self.device)
        self.timer = FrameTimer().start()
        self.mouse_pos = (0.0, 0.0)
        self.mouse_pressed = False

    def _build(self):
        """Derive the step functions and the schedule from self.config:
        at construction and after a config change (the uniform-radius
        fallback of a spawn)."""
        config = self.config
        self._step = make_sharded_tiled_step_fn(config, self.mesh)
        iv = max(1, config.tiled_relocate_interval)
        self._step_nr = (make_sharded_tiled_step_fn(config, self.mesh,
                                                    do_relocate=False)
                         if iv > 1 else self._step)
        self._reloc_iv = iv
        self._since_reloc = 0
        # the pull relocate is one hop a step: the exact claim sweep at
        # the sort cadence (240 when unset) is its multi-hop safety net;
        # the claim relocate is exact every step and needs none
        pull = tiled._backend(config.tiled_relocate, self.state[0],
                              "tiled_relocate")
        self._sweep_interval = config.sort_interval_steps
        if pull and not self._sweep_interval:
            self._sweep_interval = 240
        if pull:
            self._sweep = make_sharded_tiled_step_fn(config, self.mesh,
                                                     relocate_only=True)
        else:
            self._sweep = None
            self._sweep_interval = 0
        self._inserts = None

    def params(self, dt=None) -> StepParams:
        return StepParams.make(
            self.config.dt if dt is None else dt,
            mouse=self.mouse_pos, pressed=self.mouse_pressed)

    @property
    def per_chip_overflow(self) -> np.ndarray:
        """Cumulative deferrals per slab (one host read)."""
        return self._drops_dev.cpu().numpy().astype(np.int64)

    def _apply(self, fn, p) -> None:
        self.state, drops = fn(self.state, p)
        self._drops_dev = self._drops_dev + drops

    def _maybe_sweep(self, p) -> None:
        if (self._sweep_interval and self._steps_done
                and self._steps_done % self._sweep_interval == 0):
            self._apply(self._sweep, p)
            self._since_reloc = 0  # the exact sweep restores storage==home

    def _single_step(self, p) -> None:
        """One step under the relocate interval's counter."""
        off = (self._reloc_iv > 1
               and self._since_reloc < self._reloc_iv - 1)
        self._apply(self._step_nr if off else self._step, p)
        self._since_reloc = self._since_reloc + 1 if off else 0

    def step(self, params: Optional[StepParams] = None):
        p = params or self.params()
        self._maybe_sweep(p)
        self._single_step(p)
        self._steps_done += 1
        return self.state

    def run(self, n_steps: int):
        """Windows of CHUNK steps in relocate-first groups of the relocate
        interval where the sweep cadence leaves room, single steps
        otherwise; the sweep at its cadence between them."""
        p = self.params()
        done = 0
        while done < n_steps:
            self._maybe_sweep(p)
            bound = n_steps - done
            if self._sweep_interval:
                rem = self._steps_done % self._sweep_interval
                bound = min(bound, self._sweep_interval - rem
                            if rem else self._sweep_interval)
            if bound >= self.CHUNK:
                took = self.CHUNK
                for j in range(took):
                    self._apply(self._step if j % self._reloc_iv == 0
                                else self._step_nr, p)
                # the window's tail leaves (took - 1) % iv off-steps
                self._since_reloc = ((took - 1) % self._reloc_iv
                                     if self._reloc_iv > 1 else 0)
            else:
                self._single_step(p)
                took = 1
            self._steps_done += took
            done += took
            self.timer.get_delta(frames=took)
        return self.state

    # ---- interaction ----

    def press_mouse(self, world_pos):
        self.mouse_pos = tuple(map(float, world_pos))
        self.mouse_pressed = True

    def release_mouse(self):
        self.mouse_pressed = False

    def move_mouse(self, world_pos):
        self.mouse_pos = tuple(map(float, world_pos))

    def spawn_at(self, world_pos, count: Optional[int] = None,
                 verbose: bool = True):
        """The reference's ring burst of ``count`` (default spawn_burst)
        particles of radius 1 .. min(3, tile_max_radius), from the
        engine's generator; they need tile_max_radius >= 1.  Mixed radii
        turn tiled_uniform_radius off."""
        from gpu_physics_engine_torch.ops.spawn import ring_burst

        cfg = self.config
        count = count or cfg.spawn_burst
        r_hi = int(min(3.0, cfg.tile_max_radius_effective))
        if r_hi < 1:
            raise ValueError("spawning needs tile_max_radius >= 1")
        sx, sy, radii = ring_burst(self._gen, world_pos[0], world_pos[1],
                                   count, max_spawn_radius=r_hi)
        sx = torch.clamp(sx, 0.0, cfg.world_width - 1e-3)
        sy = torch.clamp(sy, 0.0, cfg.world_height - 1e-3)
        pos = torch.stack([sx, sy], -1).numpy()
        radii = radii.numpy()
        ids = np.arange(count, dtype=np.int32) + np.int32(self._next_pid)
        self._next_pid += count
        if cfg.tiled_uniform_radius and bool(np.any(
                radii != np.float32(cfg.initial_radius))):
            print("[tiled] spawn with non-uniform radii: disabling "
                  "tiled_uniform_radius")
            self.config = cfg.replace(tiled_uniform_radius=False)
            self._build()
        self._spawn_insert(pos, radii, ids)
        if verbose:
            print(f"Total particles: {self.num_particles()}")
        return self.state

    def _insert_fns(self):
        """(ring-1 round, far-spill placement), made on first use."""
        if self._inserts is None:
            self._inserts = (make_sharded_insert(self.config, self.mesh),
                             make_sharded_place_at(self.config, self.mesh))
        return self._inserts

    def _spawn_insert(self, pos, radii, ids) -> None:
        """Home tile and ring 1 on the slabs, then the entries still
        unplaced at the nearest free tiles the host finds in the free
        counts of every slab (``tiled.far_targets``).  Only a full
        interior grid refuses an entry, into overflow_count."""
        ring1, place_at = self._insert_fns()
        n = np.asarray(radii).reshape(-1).shape[0]
        placed = torch.zeros(n, dtype=torch.bool, device=self.device)
        self.state, placed = ring1(self.state, pos, radii, ids, placed)
        if not bool(placed.all()):
            t, TY, TX = tiled.tile_geometry(self.config)
            ty_hi = TY - 2
            free = torch.cat([(s.pid < 0).sum(dim=0).cpu()
                              for s in self.state]).numpy()
            p_np = np.asarray(pos, np.float32).reshape(-1, 2)
            hty = np.clip((p_np[:, 1] // t).astype(np.int64) + 1, 1, ty_hi)
            htx = np.clip((p_np[:, 0] // t).astype(np.int64) + 1, 1, TX - 2)
            ty2, tx2, found = tiled.far_targets(
                free, hty, htx, ~placed.cpu().numpy(), ty_hi, TX)
            if found.any():
                # entries without a target count as placed for the call,
                # so that it skips them; only real placements are kept
                skip = torch.as_tensor(~found).to(self.device)
                self.state, placed2 = place_at(self.state, pos, radii, ids,
                                               ty2, tx2, placed | skip)
                placed = placed | (placed2 & ~skip)
        n_placed = int(placed.sum())
        s0 = self.state[0]
        self.state = with_counters(
            self.state, s0.num_active + n_placed,
            s0.overflow_count + (n - n_placed))

    # ---- downloads ----

    def num_particles(self) -> int:
        return int(self.state[0].num_active)

    def gathered(self, device="cpu") -> TileState:
        """The slabs as one [cap, TYp, TX] TileState on ``device``."""
        return gather_tiles(self.state, device=device)

    def _export(self):
        return tiled.export_particles(self.gathered())

    def positions(self) -> np.ndarray:
        return self._export()[1]

    def previous_positions(self) -> np.ndarray:
        return self._export()[2]

    def radii(self) -> np.ndarray:
        return self._export()[3]

    def velocities(self) -> np.ndarray:
        _, pos, prev, _ = self._export()
        return pos - prev

    def cell_size(self) -> float:
        return tiled.tile_geometry(self.config)[0]

    # ---- checkpoints (cross-topology: particles by pid, not the layout;
    # per_chip_overflow restarts at zero, overflow_count is stored) ----

    def save_checkpoint(self, path: str) -> None:
        from gpu_physics_engine_torch.utils.checkpoint import (
            save_tiled_checkpoint)
        save_tiled_checkpoint(path, self.gathered(), self.config)

    @classmethod
    def from_checkpoint(cls, path: str, mesh: Optional[Mesh] = None,
                        seed: int = 0, **config_overrides
                        ) -> "ShardedTiledEngine":
        from gpu_physics_engine_torch.utils.checkpoint import (
            load_tiled_bigs, peek_tiled_config)
        if load_tiled_bigs(path) is not None:
            raise ValueError(
                "checkpoint carries a big-particle overlay; the sharded "
                "engine has no overlay support — resume on the "
                "single-chip TiledEngine")
        config = peek_tiled_config(path)
        if config_overrides:
            config = config.replace(**config_overrides)
        with np.load(path) as z:
            arrays = (z["positions"], z["radii"], z["pid"],
                      z["previous_positions"])
            eng = cls(config, mesh=mesh, seed=seed, initial_arrays=arrays)
            oc = eng.state[0].overflow_count + int(z["overflow"])
        eng.state = with_counters(eng.state, overflow_count=oc)
        return eng
