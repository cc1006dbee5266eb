"""Engine facade over the persistent tiled pipeline
(``gpu_physics_engine_tpu.core.tiled_engine.TiledEngine``).

Runs eagerly: ``run`` is a Python loop over steps that keeps the JAX
engine's window bookkeeping (relocate-first groups of
``tiled_relocate_interval`` steps in CHUNK-long windows, single steps with
the steps-since-relocate counter otherwise), the periodic exact sweep and
the storage-jam watchdog at run() boundaries.  A step issues its kernels
on the current CUDA stream and never waits for the device; the sweep and
the watchdog synchronise once each.

The periodic sweep is the claim relocate or the wholesale rebuild
(tiled_sweep); with tiled_rebuild_every = k (the hybrid) every k-th sweep
is the rebuild instead; tiled_sweep="bands" follows each claim sweep with
tiled_band_k band drains (``tiled.rebuild_band``) placed where
``tiled.stale_per_row`` finds the most drainable stale slots (one
[TY]-int host read a sweep).  The watchdog drains through the rebuild
when the hybrid is configured, else through the configured sweep, then
the bands.  ``save_checkpoint`` / ``from_checkpoint`` write and read the
JAX package's .npz format (utils/checkpoint), the overlay included.

The engine runs on the CUDA card unless the caller passes a device;
without a card and without ``device="cpu"`` it raises.  The
reference-exact Gauss-Seidel solver (tiled_solver="gs") runs the same
schedule with a relocate on every step, in any gs_layout.  Under "par"
(ops/gs_parity) a run() window converts the state to parity space once,
steps there and converts back at its end; single steps use the one-step
facade.  The sweep, the watchdog and the downloads see the full-space
state at window boundaries, as in the JAX package.

``spawn_at`` makes the reference's ring burst of radius 1-3 particles.
Those that fit the tile geometry go into the tiles (home tile, ring 1,
then the nearest free tile the host finds); the larger ones go into the
big-particle overlay (ops/bigs.py), which from then on couples to the
tiles in every step (``hybrid_step_fn``); with tiled_spawn="retile" the
engine re-tiles for the largest radius instead.  The overlay survives the
sweeps, the watchdog's re-tiles and the cap growth; the downloads merge
it with the tiles by pid.

The device compositor (render/device.py) draws frames on the engine's
device: ``render_frame`` (the overlay splatted over it on the host),
``step_render_frame`` (one step, then a frame) and ``render_run``
(``run``'s windows with a frame after every step, the reference's frame
loop; it raises with an overlay, as in the JAX package), which returns a
checksum of its frames.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.state import ParamCache, StepParams
from gpu_physics_engine_torch.ops import bigs, gs_parity, tiled
from gpu_physics_engine_torch.ops.spawn import ring_burst
from gpu_physics_engine_torch.render import colormap, rasterizer
from gpu_physics_engine_torch.render import device as render
from gpu_physics_engine_torch.utils.timer import FrameTimer


def _auto_cap(config: SimConfig, positions) -> int:
    """tile_cap from the initial scene: 1.5x the densest tile, rounded up
    to a multiple of 4 (min 8)."""
    t, TY, TX = tiled.tile_geometry(config)
    ty = np.clip((positions[:, 1] // t).astype(np.int64) + 1, 1, TY - 2)
    tx = np.clip((positions[:, 0] // t).astype(np.int64) + 1, 1, TX - 2)
    occ = np.bincount(ty * TX + tx, minlength=TY * TX).max() if len(ty) else 0
    return max(8, int(-(-1.5 * occ // 4)) * 4)


def default_device(device=None) -> torch.device:
    """``device`` as given; else the CUDA card, and without one a
    RuntimeError: the engine never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run the engine on the CPU")
    return torch.device("cuda")


class TiledEngine:
    CHUNK = 16  # steps per run() window

    def __init__(self, config: SimConfig, seed: int = 0,
                 initial_state: Optional[tiled.TileState] = None,
                 chunk: Optional[int] = None, device=None):
        if chunk is not None:
            self.CHUNK = int(chunk)
        if initial_state is not None:
            self.device = initial_state.device
        else:
            self.device = default_device(device)
        self.config = config
        self._gen = torch.Generator().manual_seed(int(seed))
        if initial_state is None:
            n = config.initial_particles
            u = torch.rand((2, n), generator=self._gen, dtype=torch.float32)
            positions = np.stack([
                u[0].numpy() * np.float32(config.world_width),
                u[1].numpy() * np.float32(config.world_height)], -1)
            radii = np.full(n, config.initial_radius, np.float32)
            if config.tile_cap == 0:
                self.config = config = config.replace(
                    tile_cap=_auto_cap(config, positions))
            initial_state = tiled.init_tiles(config, positions, radii,
                                             device=self.device)
        elif config.tile_cap == 0:
            self.config = config = config.replace(
                tile_cap=int(initial_state.dims[0]))
        self.state = initial_state
        if config.tiled_uniform_radius:
            # the uniform-radius sweep never reads the radius planes; a
            # state that violates the premise falls back to the general one
            occ = self.state.occupied()
            if bool(occ.any()) and not bool(torch.all(
                    self.state.radius[occ]
                    == np.float32(config.initial_radius))):
                print("[tiled] mixed radii in initial state: disabling "
                      "tiled_uniform_radius")
                self.config = config = config.replace(
                    tiled_uniform_radius=False)
        self.big: Optional[bigs.BigState] = None  # made by a big spawn
        self._next_pid = int(self.state.num_active)
        self._steps_done = 0
        self.watchdog_events = 0
        self._wd_level = 0
        self._wd_prev = None
        self._wd_retile_pct = None
        # sweep counters: they survive _configure(), as the schedule and
        # the hybrid's rebuild phase must across a watchdog re-tile
        self._sweep_count = 0
        self.rebuild_sweeps = 0
        self.band_rebuilds = 0
        self._band_rot = 0
        self._configure()
        self.timer = FrameTimer().start()
        self.mouse_pos: Tuple[float, float] = (0.0, 0.0)
        self.mouse_pressed: bool = False

    def _configure(self):
        """Derive the step schedule from self.config; called at
        construction and after a watchdog config change or re-tile."""
        config = self.config
        # the pull relocate moves one hop per step, so the exact sweep is
        # not optional when it is active
        pull_reloc = config.tiled_relocate in ("pallas", "auto")
        self._sweep_interval = config.sort_interval_steps
        if pull_reloc and not self._sweep_interval:
            self._sweep_interval = 240
        # the hybrid: every k-th periodic sweep is the wholesale rebuild
        self._rebuild_every = (config.tiled_rebuild_every
                               if config.tiled_sweep != "rebuild" else 0)
        self._reloc_iv = max(1, config.tiled_relocate_interval)
        self._since_reloc = self._reloc_iv - 1  # relocate on the next step
        # the parity-space GS pipeline: windows step in parity space
        self._gs_par = (config.tiled_solver == "gs"
                        and config.tiled_collide != "jnp"
                        and gs_parity.resolve_gs_layout(
                            config, self.device) == "par")
        self._prm = ParamCache(self.device, 1.0 / config.substeps)

    @property
    def parity_space(self) -> bool:
        """True when windows step, and ``render_run`` draws, in parity
        space (the GS "par" layout)."""
        return self._gs_par

    # ---- schedule ----

    def _sweep(self, state: tiled.TileState, off: int) -> tiled.TileState:
        """The configured exact sweep: the wholesale rebuild, or the claim
        relocate with a population-sized buffer and the tile-scan start
        ``off``.  tiled_rebuild_impl="gather" runs ``rebuild`` too: its
        placement is bit-identical to the JAX package's gather form."""
        cfg = self.config
        if cfg.tiled_sweep == "rebuild":
            return tiled.rebuild(state, cfg)
        sweep_cap = cfg.sweep_mover_capacity or max(
            cfg.mover_capacity, cfg.max_particles // 16)
        return tiled.relocate(state, cfg, m_cap=sweep_cap, tile_offset=off)

    def _sweep_off(self) -> int:
        """Count a sweep and return its rotating tile-scan start
        (golden-ratio stride); every sweep calls it, the rebuild's too."""
        self._sweep_count += 1
        return (self._sweep_count * 2654435761) & 0x7FFFFFFF

    def _run_sweep(self) -> tiled.TileState:
        """One periodic sweep: the configured one, the wholesale rebuild
        on every k-th (tiled_rebuild_every = k, the hybrid; no bands
        then), the band drains after it under "bands"."""
        off = self._sweep_off()
        k = self._rebuild_every
        if k and self._sweep_count % k == 0:
            self.rebuild_sweeps += 1
            return tiled.rebuild(self.state, self.config)
        state = self._sweep(self.state, off)
        if self.config.tiled_sweep == "bands":
            state = self._apply_bands(state)
        return state

    def _apply_bands(self, state: tiled.TileState) -> tiled.TileState:
        """tiled_band_k band drains: greedy windows of the most drainable
        stale mass in the ``stale_per_row`` histogram (one host read),
        overlapping windows suppressed; a flat histogram's leftover bands
        rotate through the rows with a stride coprime to their number, so
        successive sweeps cover the grid."""
        cfg = self.config
        _, TY, _ = tiled.tile_geometry(cfg)
        B = min(cfg.tiled_band_rows, TY)
        hist = tiled.stale_per_row(state, cfg,
                                   max_dy=cfg.tiled_band_rows).cpu().numpy()
        w = np.convolve(hist, np.ones(B, np.int64), mode="valid")
        starts = []
        for _ in range(cfg.tiled_band_k):
            i = int(w.argmax())
            if w[i] <= 0:
                break
            starts.append(i)
            w[max(0, i - B + 1):i + B] = -1  # suppress overlaps
        M = max(TY - B + 1, 1)
        stride = B
        while math.gcd(stride, M) != 1:
            stride += 1
        while len(starts) < cfg.tiled_band_k:
            self._band_rot = (self._band_rot + stride) % M
            starts.append(self._band_rot)
        for r0 in starts:
            state = tiled.rebuild_band(state, cfg, r0,
                                       rows=cfg.tiled_band_rows)
        self.band_rebuilds += len(starts)
        return state

    def _reloc_off(self) -> bool:
        """True when this step may skip the relocate."""
        return (self._reloc_iv > 1
                and self._since_reloc < self._reloc_iv - 1)

    def params(self, dt: Optional[float] = None) -> StepParams:
        return StepParams.make(
            self.config.dt if dt is None else dt,
            mouse=self.mouse_pos, pressed=self.mouse_pressed)

    def _advance(self, params: StepParams, relocate: bool) -> None:
        """One step: with an overlay the hybrid step over (tiles, bigs)."""
        if self.big is not None:
            self.state, self.big = bigs.hybrid_step_fn(
                self.state, self.big, params, self.config,
                do_relocate=relocate, prm=self._prm(params))
            return
        self.state = tiled.tiled_step_fn(self.state, params, self.config,
                                         do_relocate=relocate,
                                         prm=self._prm(params))

    def _window(self, params: StepParams, steps: int, frame=None) -> None:
        """``steps`` steps as one window: relocate-first groups of the
        relocate interval (hybrid steps with an overlay), or under "par"
        without an overlay the parity-space GS steps, which relocate on
        every step (converting once each way).  ``frame(s)``
        runs after every step on the full-space TileState, or under "par"
        on the ParityState.  The window's tail leaves (steps - 1) % iv
        un-relocated steps."""
        cfg = self.config
        if self._gs_par and self.big is None:
            tiled._backend(cfg.tiled_collide, self.state, "tiled_collide")
            ps = gs_parity.to_parity_state(self.state, cfg)
            for _ in range(steps):
                ps = gs_parity.gs_parity_step_fn(ps, params, cfg,
                                                 prm=self._prm(params))
                if frame is not None:
                    frame(ps)
            self.state = gs_parity.from_parity_state(ps, cfg)
        else:
            for j in range(steps):
                self._advance(params, relocate=(j % self._reloc_iv == 0))
                if frame is not None:
                    frame(self.state)
        self._since_reloc = ((steps - 1) % self._reloc_iv
                             if self._reloc_iv > 1 else 0)

    def sweep(self) -> None:
        """Run the periodic sweep now (``_run_sweep``)."""
        self.state = self._run_sweep()
        self._since_reloc = 0  # the exact sweep restores storage==home

    def _maybe_sweep(self) -> None:
        interval = self._sweep_interval
        if interval and self._steps_done and self._steps_done % interval == 0:
            self.sweep()

    def _to_sweep(self, left: int) -> int:
        """``left`` steps, cut at the next periodic sweep."""
        interval = self._sweep_interval
        if not interval:
            return left
        return min(left, interval - self._steps_done % interval)

    def step(self, params: Optional[StepParams] = None):
        self._maybe_sweep()
        off = self._reloc_off()
        self._advance(params or self.params(), relocate=not off)
        self._since_reloc = self._since_reloc + 1 if off else 0
        self._steps_done += 1
        return self.state

    def run(self, n_steps: int, sync_every: int = 0):
        """Advance ``n_steps``: CHUNK-long windows of relocate-first groups
        where the sweep cadence leaves room, single steps otherwise; then
        the cap-growth check and the watchdog."""
        p = self.params()
        done = 0
        of_before = (int(self.state.overflow_count)
                     if self.config.tiled_auto_cap_pct else 0)
        while done < n_steps:
            self._maybe_sweep()
            bound = self._to_sweep(n_steps - done)
            if sync_every:
                bound = min(bound, sync_every - done % sync_every
                            if done % sync_every else sync_every)
            if bound >= self.CHUNK:
                took = self.CHUNK
                self._window(p, took)
            else:
                off = self._reloc_off()
                self._advance(p, relocate=not off)
                took = 1
                self._since_reloc = self._since_reloc + 1 if off else 0
            self._steps_done += took
            done += took
            if sync_every and done % sync_every == 0:
                self._sync()
            self.timer.get_delta(frames=took)
        self._maybe_grow_cap(n_steps, of_before)
        self._watchdog()
        return self.state

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- storage-jam watchdog and capacity growth ----

    def _watchdog(self):
        """Detect a growing stale-pair population at run() boundaries and
        escalate: forced exact sweep -> hysteresis off -> +1 slot capacity
        (repeatable, with a futility check).  Each escalation prints and
        increments ``watchdog_events``."""
        cfg = self.config
        if not cfg.tiled_watchdog:
            return
        pct = float(tiled.stale_pair_fraction(self.state, cfg)) * 100.0
        prev, self._wd_prev = self._wd_prev, pct
        bound = cfg.tiled_watchdog_pct
        if pct <= bound or prev is None:
            return  # healthy, or no slope yet
        growing = pct > max(prev * 1.25, prev + 0.2)
        runaway = pct > 4.0 * bound
        if not growing and not runaway:
            return  # a settled plateau is the user's geometry choice
        self.watchdog_events += 1
        if growing:
            self._wd_level = min(self._wd_level + 1, 3)
        else:
            self._wd_level = max(self._wd_level, 1)
        if self._wd_level >= 3 and self._wd_retile_pct is not None \
                and pct >= self._wd_retile_pct:
            print("[tiled][watchdog] capacity growth did not reduce "
                  f"stale ({pct:.2f}% >= {self._wd_retile_pct:.2f}% at "
                  "the last retile): structural jam — holding at "
                  "forced-sweep containment")
            self._wd_level = 1
        act = {1: "forced exact sweep",
               2: "hysteresis off",
               3: f"tile_cap {cfg.tile_cap} -> {cfg.tile_cap + 1}"}[
                   self._wd_level]
        why = (f"growing (was {prev:.2f}%)" if growing
               else f"past the {4.0 * bound:.0f}% runaway ceiling "
                    f"(flat, was {prev:.2f}%)")
        print(f"[tiled][watchdog] stale-pair population {pct:.2f}% > "
              f"{bound}% and {why}: {act}")
        if self._wd_level >= 2 and cfg.hysteresis_delta > 0.0:
            self.config = self.config.replace(tiled_hysteresis=0.0)
            self._configure()
        if self._wd_level >= 3:
            self._retile_cap(self.config.tile_cap + 1)
            self._wd_retile_pct = pct
            self._wd_level = 2  # cap growth is repeatable
        # drain with the strongest sweep there is: the rebuild when the
        # hybrid is configured, else the configured sweep, then the bands
        off = self._sweep_off()
        if self._rebuild_every:
            self.state = tiled.rebuild(self.state, self.config)
        else:
            self.state = self._sweep(self.state, off)
        if self.config.tiled_sweep == "bands":
            self.state = self._apply_bands(self.state)
        self._since_reloc = 0
        self._wd_prev = float(
            tiled.stale_pair_fraction(self.state, self.config)) * 100.0

    def _retile_as(self, config: SimConfig) -> None:
        """Re-tile every tile particle under ``config`` (positions,
        previous positions, pids and the overflow count carried; the
        overlay is untouched)."""
        pids, pos, prev, radii = tiled.export_particles(self.state)
        overflow = int(self.state.overflow_count)
        if config.tile_cap == 0:
            config = config.replace(tile_cap=_auto_cap(config, pos))
        self.config = config
        self.state = tiled.init_tiles(config, pos, radii, pids=pids,
                                      previous_positions=prev,
                                      device=self.device)
        self.state = self.state.replace(
            overflow_count=self.state.overflow_count + overflow)
        self._configure()

    def _retile_cap(self, new_cap: int):
        """Re-tile at the same geometry with a bigger slot capacity."""
        self._retile_as(self.config.replace(tile_cap=int(new_cap)))

    def _retile(self, tile_max_radius: float):
        """Re-tile so that particles up to ``tile_max_radius`` fit: the
        reference's cell sizing (edge 2.2 x the radius) and a cap sized
        from the scene, as its grid rebuild after a spawn does."""
        self._retile_as(self.config.replace(
            tile_max_radius=float(tile_max_radius), tile_multiplier=2.2,
            tile_cap=0))

    def _maybe_grow_cap(self, steps: int, overflow_before: int):
        """config.tiled_auto_cap_pct: re-tile with +1 slot capacity when the
        deferred population over the finished run() window exceeds it."""
        pct_bound = self.config.tiled_auto_cap_pct
        if not pct_bound or steps <= 0:
            return
        n = max(1, self.num_particles())
        delta = int(self.state.overflow_count) - overflow_before
        pct = delta / steps / n * 100.0 * max(
            1, self.config.tiled_relocate_interval)
        if pct > pct_bound:
            print(f"[tiled] deferred population {pct:.2f}%/step > "
                  f"{pct_bound}%: growing tile_cap "
                  f"{self.config.tile_cap} -> {self.config.tile_cap + 1}")
            self._retile_cap(self.config.tile_cap + 1)

    @classmethod
    def from_arrays(cls, config: SimConfig, positions, radii, device=None,
                    **kw):
        """Engine over a given scene, on the CUDA card unless ``device``
        says otherwise (raises without a card)."""
        device = default_device(device)
        if config.tile_cap == 0:
            config = config.replace(tile_cap=_auto_cap(
                config, np.asarray(positions, np.float32).reshape(-1, 2)))
        st = tiled.init_tiles(config, positions, radii, device=device, **kw)
        return cls(config, initial_state=st)

    # ---- interaction ----

    def press_mouse(self, world_pos):
        self.mouse_pos = tuple(map(float, world_pos))
        self.mouse_pressed = True

    def release_mouse(self):
        self.mouse_pressed = False

    def move_mouse(self, world_pos):
        self.mouse_pos = tuple(map(float, world_pos))

    def _spawn_insert(self, pos, radii, ids) -> None:
        """Insert particles that fit the tiles: home tile, ring 1, then
        the nearest free tile (``tiled.spawn_insert_into``)."""
        self.state = tiled.spawn_insert_into(self.state, self.config, pos,
                                             radii, ids)

    def spawn_at(self, world_pos, count: Optional[int] = None,
                 verbose: bool = True):
        """The reference's ring burst of ``count`` (default spawn_burst)
        particles of radius 1-3 around ``world_pos``, drawn from the
        engine's generator.  Radii the tiles fit go into the tiles, larger
        ones into the overlay (or, with tiled_spawn="retile", the engine
        re-tiles first); a radius that breaks the uniform-radius premise
        turns tiled_uniform_radius off."""
        cfg = self.config
        count = count or cfg.spawn_burst
        needed = float(min(cfg.spawn_radius_max, 3.0))
        if cfg.tile_max_radius is not None:
            # an explicit geometry caps the spawn radii
            if cfg.tile_max_radius_effective < 1.0:
                raise ValueError(
                    "spawning needs SimConfig.tile_max_radius >= spawn "
                    f"radius (min 1.0); tiling was sized for "
                    f"{cfg.tile_max_radius_effective}")
            fits_tiles = True
        else:
            fits_tiles = cfg.tile_max_radius_effective >= needed
            if not fits_tiles and cfg.tiled_spawn == "retile":
                self._retile(needed)
                fits_tiles = True
        cfg = self.config
        if not fits_tiles and cfg.tiled_solver == "gs":
            raise ValueError(
                "tiled_solver='gs' requires tile == reference cell "
                "geometry; size tile_max_radius for the spawn radii or "
                "use tiled_spawn='retile'")
        r_max = max(1, int(min(3.0, cfg.tile_max_radius_effective))
                    if fits_tiles else int(needed))
        sx, sy, radii = ring_burst(self._gen, world_pos[0], world_pos[1],
                                   count, max_spawn_radius=r_max)
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
            self._configure()
        if fits_tiles:
            self._spawn_insert(pos, radii, ids)
        else:
            small = radii <= self.config.tile_max_radius_effective
            if small.any():
                self._spawn_insert(pos[small], radii[small], ids[small])
            if (~small).any():
                self._insert_bigs(pos[~small], radii[~small], ids[~small])
        if verbose:
            print(f"Total particles: {self.num_particles()}")
        return self.state

    def _insert_bigs(self, pos: np.ndarray, radii: np.ndarray,
                     ids: np.ndarray, prev: np.ndarray = None) -> None:
        """Insert into the overlay, made on first use with 128 slots
        (doubled past a burst) and doubled on demand up to big_capacity;
        entries past that count in overflow_count.  ``prev`` gives
        previous positions (a velocity) instead of a spawn at rest.  Reads
        the overlay's pids once."""
        cfg = self.config
        pos = np.asarray(pos, np.float32).reshape(-1, 2)
        prev = pos if prev is None else np.asarray(prev,
                                                   np.float32).reshape(-1, 2)
        m = len(ids)
        if self.big is None:
            cap0 = 128
            while cap0 < m:
                cap0 *= 2
            self.big = bigs.init_bigs(min(cap0, cfg.big_capacity),
                                      device=self.device)
        pid = self.big.pid.cpu().numpy()
        free = np.nonzero(pid < 0)[0]
        if len(free) < m and self.big.capacity < cfg.big_capacity:
            cap = self.big.capacity
            new_cap = cap
            while new_cap < int((pid >= 0).sum()) + m:
                new_cap *= 2
            new_cap = min(new_cap, cfg.big_capacity)
            self.big = bigs.grow_bigs(self.big, new_cap)
            free = np.concatenate([free, np.arange(cap, new_cap)])
        n = min(len(free), m)
        slots = torch.as_tensor(free[:n]).to(self.device)
        vals = {"x": pos[:n, 0], "y": pos[:n, 1], "px": prev[:n, 0],
                "py": prev[:n, 1],
                "radius": np.asarray(radii, np.float32)[:n],
                "pid": np.asarray(ids, np.int32)[:n]}
        upd = {}
        for f, v in vals.items():
            a = getattr(self.big, f).clone()
            a[slots] = torch.as_tensor(v).to(self.device)
            upd[f] = a
        self.big = self.big.replace(num_active=self.big.num_active + n,
                                    **upd)
        if n < m:
            self.state = self.state.replace(
                overflow_count=self.state.overflow_count + (m - n))

    # ---- downloads ----

    def num_particles(self) -> int:
        n = int(self.state.num_active)
        if self.big is not None:
            n += int(self.big.num_active)
        return n

    def _export(self):
        """(pid, positions, previous positions, radii) of the tiles and
        the overlay, by ascending pid."""
        pid, pos, prev, rad = tiled.export_particles(self.state)
        if self.big is None or int(self.big.num_active) == 0:
            return pid, pos, prev, rad
        bpid, bpos, bprev, brad = bigs.export_bigs(self.big)
        pid = np.concatenate([pid, bpid])
        order = np.argsort(pid, kind="stable")
        return (pid[order], np.concatenate([pos, bpos])[order],
                np.concatenate([prev, bprev])[order],
                np.concatenate([rad, brad])[order])

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

    # ---- device rendering (render/device.py) ----

    def render_frame(self, rect=None, width: int = 1280,
                     height: int = 720) -> np.ndarray:
        """The state's velocity-colormap frame, drawn on the engine's
        device -> host u8 [height, width, 3]; ``rect`` = (x0, y0, x1, y1),
        the world window (default: the 90% auto-fit).  The overlay's bigs
        are splatted over it on the host (render/rasterizer.py): they are
        few and large, and the tile-centred device path would distort
        them."""
        if rect is None:
            rect = render.autofit_rect(self.config, width, height)
        frame = render.render_tiles_device(self.state, self.config,
                                           rect=rect, width=width,
                                           height=height)
        if self.big is None or int(self.big.num_active) == 0:
            return frame
        _, bpos, bprev, brad = bigs.export_bigs(self.big)
        x0, y0, x1, y1 = rect
        sx = (bpos[:, 0] - x0) * width / (x1 - x0)
        sy = (y1 - bpos[:, 1]) * height / (y1 - y0)  # world y points up
        sr = brad * width / (x1 - x0)
        rgb = colormap.velocity_colors(bpos - bprev)
        f32 = frame.astype(np.float32) / 255.0
        rasterizer.splat(f32, sx, sy, sr, rgb)
        return (np.clip(f32, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    def step_render_frame(self, rect=None, width: int = 1280,
                          height: int = 720) -> np.ndarray:
        """One step, then a frame of the state it left: the sweep check,
        the step and the relocate-interval bookkeeping of ``step()``, and
        ``render_frame``.  (The JAX engine compiles the two into one
        program to save a dispatch; eager PyTorch issues the same work.)"""
        self.step()
        return self.render_frame(rect=rect, width=width, height=height)

    def render_run(self, n_steps: int, width: int = 1280,
                   height: int = 720) -> int:
        """``run()`` with a frame drawn after every step, the reference's
        frame loop (sim and render each frame), at the auto-fit rect.
        Windows of up to CHUNK steps, cut at the periodic sweep, each in
        relocate-first groups; under "par" each window steps in parity
        space and draws each frame from there (``render_parity_core``).
        No watchdog and no cap growth, and no overlay (it raises), as in
        the JAX package.  Returns the sum of every pixel of every frame,
        wrapped to a signed int32; it is summed on the device and read
        once, at the end."""
        if self.big is not None:
            raise NotImplementedError(
                "render_run does not cover big-overlay scenes")
        draw = render.frame_drawer(self.config, width, height, self.device,
                                   parity=self._gs_par)
        acc = torch.zeros((), dtype=torch.int64, device=self.device)

        def frame(s):
            acc.add_(draw(s).sum(dtype=torch.int64))

        p = self.params()
        done = 0
        while done < n_steps:
            self._maybe_sweep()
            took = min(self._to_sweep(n_steps - done), self.CHUNK)
            self._window(p, took, frame)
            self._steps_done += took
            done += took
        return (int(acc) + (1 << 31)) % (1 << 32) - (1 << 31)

    # ---- checkpoints (utils/checkpoint.py: the JAX package's format) ----

    def save_checkpoint(self, path: str) -> None:
        """The tile particles by pid and the overlay's bigs, with the
        config as JSON."""
        from gpu_physics_engine_torch.utils.checkpoint import (
            save_tiled_checkpoint)
        save_tiled_checkpoint(path, self.state, self.config, big=self.big)

    @classmethod
    def from_checkpoint(cls, path: str, seed: int = 0, config=None,
                        device=None, **config_overrides) -> "TiledEngine":
        """An engine resumed from ``path``, on the CUDA card unless
        ``device`` says otherwise.  ``config`` replaces the stored one
        wholesale, ``config_overrides`` patch fields of it; the particles
        re-tile under the result, so geometry changes are safe.  The
        overlay's bigs are re-inserted with their previous positions, and
        new pids start past them."""
        from gpu_physics_engine_torch.utils.checkpoint import (
            load_tiled_bigs, load_tiled_checkpoint, peek_tiled_config)
        if config is None:
            config = peek_tiled_config(path)
        if config_overrides:
            config = config.replace(**config_overrides)
        state, _ = load_tiled_checkpoint(path, config=config, device=device)
        eng = cls(config, seed=seed, initial_state=state)
        stored = load_tiled_bigs(path)
        if stored is not None:
            bpid, bpos, bprev, brad = stored
            eng._insert_bigs(bpos, brad, bpid, prev=bprev)
            eng._next_pid = max(eng._next_pid, int(np.max(bpid)) + 1)
        return eng
