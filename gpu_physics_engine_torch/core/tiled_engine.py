"""Engine facade over the persistent tiled pipeline
(``gpu_physics_engine_tpu.core.tiled_engine.TiledEngine``).

Runs eagerly: ``run`` is a Python loop over steps that keeps the JAX
engine's window bookkeeping (relocate-first groups of
``tiled_relocate_interval`` steps in CHUNK-long windows, single steps with
the steps-since-relocate counter otherwise), the periodic exact sweep and
the storage-jam watchdog at run() boundaries.  A step issues its kernels
on the current CUDA stream and never waits for the device; the sweep and
the watchdog synchronise once each.

The engine runs on the CUDA card unless the caller passes a device;
without a card and without ``device="cpu"`` it raises.  The
reference-exact Gauss-Seidel solver (tiled_solver="gs") runs the same
schedule with a relocate on every step, in any gs_layout.  Under "par"
(ops/gs_parity) a run() window converts the state to parity space once,
steps there and converts back at its end; single steps use the one-step
facade.  The sweep, the watchdog and the downloads see the full-space
state at window boundaries, as in the JAX package.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
tiled_sweep="bands", tiled_rebuild_every > 0, the GS mega kernels, spawns
and the big-particle overlay, rendering, checkpoints.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.state import StepParams
from gpu_physics_engine_torch.ops import gs_parity, tiled
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


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet ({item})")


def _check_supported(config: SimConfig) -> None:
    if config.tiled_sweep == "bands":
        raise _not_ported("tiled_sweep='bands'",
                          "ROADMAP.md queue 1, item 2: rebuild_band")
    if config.tiled_rebuild_every > 0:
        raise _not_ported("tiled_rebuild_every > 0 (the hybrid sweep)",
                          "ROADMAP.md queue 1, item 4: sweep modes")
    tiled.check_gs_supported(config)


class TiledEngine:
    CHUNK = 16  # steps per run() window

    def __init__(self, config: SimConfig, seed: int = 0,
                 initial_state: Optional[tiled.TileState] = None,
                 chunk: Optional[int] = None, device=None):
        _check_supported(config)
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
        self._next_pid = int(self.state.num_active)
        self._steps_done = 0
        self.watchdog_events = 0
        self._wd_level = 0
        self._wd_prev = None
        self._wd_retile_pct = None
        self._sweep_count = 0
        self._prm_cache = {}
        self._configure()
        self.timer = FrameTimer().start()
        self.mouse_pos: Tuple[float, float] = (0.0, 0.0)
        self.mouse_pressed: bool = False

    def _configure(self):
        """Derive the step schedule from self.config; called at
        construction and after a watchdog config change or re-tile."""
        config = self.config
        _check_supported(config)
        # the pull relocate moves one hop per step, so the exact sweep is
        # not optional when it is active
        pull_reloc = config.tiled_relocate in ("pallas", "auto")
        self._sweep_interval = config.sort_interval_steps
        if pull_reloc and not self._sweep_interval:
            self._sweep_interval = 240
        self._reloc_iv = max(1, config.tiled_relocate_interval)
        self._since_reloc = self._reloc_iv - 1  # relocate on the next step
        # the parity-space GS pipeline: windows step in parity space
        self._gs_par = (config.tiled_solver == "gs"
                        and config.tiled_collide != "jnp"
                        and gs_parity.resolve_gs_layout(
                            config, self.device) == "par")
        self._prm_cache.clear()

    # ---- schedule ----

    def _sweep(self, state: tiled.TileState) -> tiled.TileState:
        """The exact periodic sweep: wholesale rebuild, or the claim
        relocate with a population-sized buffer and a rotating tile-scan
        start."""
        cfg = self.config
        if cfg.tiled_sweep == "rebuild":
            return tiled.rebuild(state, cfg)
        sweep_cap = cfg.sweep_mover_capacity or max(
            cfg.mover_capacity, cfg.max_particles // 16)
        return tiled.relocate(state, cfg, m_cap=sweep_cap,
                              tile_offset=self._sweep_off())

    def _sweep_off(self) -> int:
        """Rotating tile-scan start (golden-ratio stride)."""
        self._sweep_count += 1
        return (self._sweep_count * 2654435761) & 0x7FFFFFFF

    def _reloc_off(self) -> bool:
        """True when this step may skip the relocate."""
        return (self._reloc_iv > 1
                and self._since_reloc < self._reloc_iv - 1)

    def params(self, dt: Optional[float] = None) -> StepParams:
        return StepParams.make(
            self.config.dt if dt is None else dt,
            mouse=self.mouse_pos, pressed=self.mouse_pressed)

    def _prm(self, params: StepParams) -> torch.Tensor:
        """Device [dt/substeps, mx, my, pressed] for ``params``, built once
        per distinct value so steps never copy it to the device."""
        prm = self._prm_cache.get(params)
        if prm is None:
            if len(self._prm_cache) > 64:
                self._prm_cache.clear()
            prm = params.as_tensor(self.device, 1.0 / self.config.substeps)
            self._prm_cache[params] = prm
        return prm

    def _advance(self, params: StepParams, relocate: bool) -> None:
        self.state = tiled.tiled_step_fn(self.state, params, self.config,
                                         do_relocate=relocate,
                                         prm=self._prm(params))

    def _par_window(self, params: StepParams, steps: int) -> None:
        """``steps`` GS steps in parity space, converting once each way."""
        cfg = self.config
        tiled._backend(cfg.tiled_collide, self.state, "tiled_collide")
        ps = gs_parity.to_parity_state(self.state, cfg)
        for _ in range(steps):
            ps = gs_parity.gs_parity_step_fn(ps, params, cfg,
                                             prm=self._prm(params))
        self.state = gs_parity.from_parity_state(ps, cfg)

    def sweep(self) -> None:
        """Run the exact sweep now (the periodic sweep and the watchdog's
        forced sweep both come through here)."""
        self.state = self._sweep(self.state)
        self._since_reloc = 0  # the exact sweep restores storage==home

    def _maybe_sweep(self) -> None:
        interval = self._sweep_interval
        if interval and self._steps_done and self._steps_done % interval == 0:
            self.sweep()

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
        interval = self._sweep_interval
        done = 0
        of_before = (int(self.state.overflow_count)
                     if self.config.tiled_auto_cap_pct else 0)
        while done < n_steps:
            self._maybe_sweep()
            bound = n_steps - done
            if interval:
                bound = min(bound, interval - self._steps_done % interval
                            if self._steps_done % interval else interval)
            if sync_every:
                bound = min(bound, sync_every - done % sync_every
                            if done % sync_every else sync_every)
            if bound >= self.CHUNK:
                if self._gs_par:  # GS relocates on every step
                    self._par_window(p, self.CHUNK)
                else:
                    for j in range(self.CHUNK):
                        self._advance(p, relocate=(j % self._reloc_iv == 0))
                took = self.CHUNK
                # a window's tail has (CHUNK-1) % iv un-relocated steps
                self._since_reloc = ((took - 1) % self._reloc_iv
                                     if self._reloc_iv > 1 else 0)
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
        self.sweep()
        self._wd_prev = float(
            tiled.stale_pair_fraction(self.state, self.config)) * 100.0

    def _retile_cap(self, new_cap: int):
        """Re-tile at the same geometry with a bigger slot capacity."""
        pids, pos, prev, radii = tiled.export_particles(self.state)
        overflow = int(self.state.overflow_count)
        self.config = self.config.replace(tile_cap=int(new_cap))
        self.state = tiled.init_tiles(self.config, pos, radii, pids=pids,
                                      previous_positions=prev,
                                      device=self.device)
        self.state = self.state.replace(
            overflow_count=self.state.overflow_count + overflow)
        self._configure()

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

    def spawn_at(self, *args, **kwargs):
        raise _not_ported("spawn_at (spawns and the big-particle overlay)",
                          "ROADMAP.md queue 1, item 7")

    # ---- downloads ----

    def num_particles(self) -> int:
        return int(self.state.num_active)

    def positions(self) -> np.ndarray:
        return tiled.export_particles(self.state)[1]

    def previous_positions(self) -> np.ndarray:
        return tiled.export_particles(self.state)[2]

    def radii(self) -> np.ndarray:
        return tiled.export_particles(self.state)[3]

    def velocities(self) -> np.ndarray:
        _, pos, prev, _ = tiled.export_particles(self.state)
        return pos - prev

    def cell_size(self) -> float:
        return tiled.tile_geometry(self.config)[0]

    # ---- not ported yet ----

    def save_checkpoint(self, path: str) -> None:
        raise _not_ported("checkpoints", "ROADMAP.md queue 1, item 4")

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "TiledEngine":
        raise _not_ported("checkpoints", "ROADMAP.md queue 1, item 4")

    def render_frame(self, *args, **kwargs):
        raise _not_ported("render_frame", "ROADMAP.md queue 1, item 5")

    def render_run(self, *args, **kwargs):
        raise _not_ported("render_run", "ROADMAP.md queue 1, item 5")

    def step_render_frame(self, *args, **kwargs):
        raise _not_ported("step_render_frame", "ROADMAP.md queue 1, item 5")
