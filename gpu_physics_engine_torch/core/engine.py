"""Engine over the array pipelines (``gpu_physics_engine_tpu.core.engine``).

Owns the particle state, the frame step (core/stepper), the spawn path and
the latched mouse input.  It runs eagerly: ``run`` is a Python loop over
steps.  The Morton resort cadence is kept in a host-side counter beside
the state's own steps_since_sort, so a step reads nothing back from the
device and ``run`` synchronises only where ``sync_every`` says and once
at its end.

Runs on the CUDA card unless the caller passes a device; without a card
and without ``device="cpu"`` it raises.  Checkpoints: utils/checkpoint
(``save_checkpoint(path, eng.state, eng.config)``, then
``Engine(config, initial_state=state)`` from ``load_checkpoint``) resume
with the same resort step as an engine that never stopped: the host
counter starts from the state's steps_since_sort.

    eng = Engine(SimConfig(initial_particles=100_000))  # on the card
    eng.run(600)
    eng.press_mouse((100.0, 100.0))
    eng.spawn_at((100.0, 100.0))
    pos = eng.positions()
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gpu_physics_engine_torch.core import state as state_lib
from gpu_physics_engine_torch.core import stepper
from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.state import ParticleState, StepParams
from gpu_physics_engine_torch.core.tiled_engine import default_device
from gpu_physics_engine_torch.ops import collision, grid, spawn
from gpu_physics_engine_torch.utils.timer import FrameTimer


class Engine:
    def __init__(self, config: SimConfig, seed: int = 0,
                 initial_state: Optional[ParticleState] = None, device=None):
        self.config = config
        self._gen = torch.Generator().manual_seed(int(seed))
        if initial_state is None:
            self.device = default_device(device)
            initial_state = state_lib.init_uniform(config, self._gen,
                                                   device=self.device)
        else:
            self.device = initial_state.device
        self.state = initial_state
        self._step = stepper.make_step(config)
        # the resort cadence on the host: the state's steps_since_sort,
        # read once here
        self._since_sort = int(initial_state.steps_since_sort)
        self._prm = state_lib.ParamCache(self.device,
                                         1.0 / config.substeps)
        self.timer = FrameTimer().start()
        self.mouse_pos: Tuple[float, float] = (0.0, 0.0)
        self.mouse_pressed: bool = False

    @classmethod
    def from_arrays(cls, config: SimConfig, positions, radii, device=None,
                    **kw) -> "Engine":
        """Engine over a given scene (the test-fixture path), on the CUDA
        card unless ``device`` says otherwise (raises without a card)."""
        st = state_lib.from_arrays(config, positions, radii,
                                   device=default_device(device), **kw)
        return cls(config, initial_state=st)

    def params(self, dt: Optional[float] = None) -> StepParams:
        return StepParams.make(
            self.config.dt if dt is None else dt,
            mouse=self.mouse_pos, pressed=self.mouse_pressed)

    # ---- frame loop ----

    def step(self, params: Optional[StepParams] = None) -> ParticleState:
        """Advance one frame."""
        iv = self.config.sort_interval_steps
        resort_now = iv > 0 and self._since_sort >= iv
        self.state = self._step(self.state, self._prm(params or self.params()),
                                resort_now)
        self._since_sort = 1 if resort_now else self._since_sort + 1
        return self.state

    def run(self, n_steps: int, sync_every: int = 0) -> ParticleState:
        """Advance ``n_steps`` frames with the latched input; synchronise
        every ``sync_every`` steps (0: only at the end)."""
        p = self.params()
        for done in range(1, n_steps + 1):
            self.step(p)
            if sync_every and done % sync_every == 0:
                self._sync()
            self.timer.get_delta()
        self._sync()
        return self.state

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- interaction ----

    def press_mouse(self, world_pos: Tuple[float, float]):
        self.mouse_pos = tuple(map(float, world_pos))
        self.mouse_pressed = True

    def release_mouse(self):
        self.mouse_pressed = False

    def move_mouse(self, world_pos: Tuple[float, float]):
        self.mouse_pos = tuple(map(float, world_pos))

    def spawn_at(self, world_pos: Tuple[float, float],
                 count: Optional[int] = None, verbose: bool = True):
        """Spawn a burst around a point (the reference's `P` key).  A burst
        that would pass max_particles is refused whole."""
        count = count or self.config.spawn_burst
        burst = spawn.ring_burst(self._gen, float(world_pos[0]),
                                 float(world_pos[1]), count)
        colors = (spawn.burst_colors(self._gen, count)
                  if self.config.track_colors else None)
        self.state = spawn.add_particles(self.config, self.state, *burst,
                                         colors=colors)
        if verbose:
            print(f"Total particles: {self.num_particles()}")
        return self.state

    # ---- host downloads ----

    def num_particles(self) -> int:
        return int(self.state.num_active)

    def _live(self, a: torch.Tensor) -> np.ndarray:
        return a[: self.num_particles()].cpu().numpy()

    def positions(self) -> np.ndarray:
        return np.stack([self._live(self.state.x), self._live(self.state.y)],
                        axis=-1)

    def previous_positions(self) -> np.ndarray:
        return np.stack([self._live(self.state.px),
                         self._live(self.state.py)], axis=-1)

    def radii(self) -> np.ndarray:
        return self._live(self.state.radius)

    def velocities(self) -> np.ndarray:
        return self.positions() - self.previous_positions()

    def cell_size(self) -> float:
        return float(self.config.cell_size(float(self.state.max_radius)))

    # ---- debug downloads (the reference's grid and collision-cell
    # buffers, for tests and inspection) ----

    def debug_grid(self):
        """(sorted cell_ids as u32 values in int64 [4 cap], object_ids i32
        [4 cap]) of the current state, sorted as the step sorts them."""
        st = self.state
        cand = grid.build_candidates(st.x, st.y, st.radius, st.active_mask(),
                                     stepper.cell_size(self.config, st))
        sc, so = grid.sort_map(*grid.build_cell_ids(cand),
                               impl=self.config.sort_impl)
        return sc.cpu().numpy(), so.cpu().numpy()

    def debug_collision_cells(self):
        """(start indices int64 [4 cap] UNUSED-padded, total)."""
        sc, _ = self.debug_grid()
        cells, total = collision.build_collision_cells(torch.from_numpy(sc))
        return cells.numpy(), int(total)
