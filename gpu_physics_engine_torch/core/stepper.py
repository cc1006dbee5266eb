"""One frame of the array pipelines (``gpu_physics_engine_tpu.core.stepper``).

The reference's frame: the Morton resort (every sort interval), then per
substep the grid build, the stable sort of the (cell, object) pairs or the
bucket table, the collision-cell extraction, the 4-color Gauss-Seidel
solve (or the Jacobi solve), and Verlet.  Plain functions on tensors; the
only hand kernel on this path is the radix sort's rank/histogram pass
(sort_impl="radix", ops/radix_sort).  Nothing here reads a value back to
the host: ``step_fn`` takes the resort decision from its caller (the
Engine keeps the cadence in a host-side counter).
"""

from __future__ import annotations

from typing import Callable

import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.state import ParticleState
from gpu_physics_engine_torch.ops import collision, grid, resort
from gpu_physics_engine_torch.ops.integrate import f32, verlet_integrate


def check_supported(config: SimConfig) -> None:
    """Raise for array-pipeline options the port does not run yet."""
    if config.solver == "fast":
        raise NotImplementedError(
            "solver='fast' is not ported yet (ROADMAP.md queue 1, "
            "\"solver='fast'\": ops/fast_solve.py)")


def cell_size(config: SimConfig, state: ParticleState) -> torch.Tensor:
    """The grid's cell edge as a 0-d f32 tensor on the state's device."""
    return config.cell_size_multiplier * state.max_radius


def substep(state: ParticleState, prm: torch.Tensor,
            config: SimConfig) -> ParticleState:
    """One collision solve + integrate pass; ``prm`` = f32[4] [dt (scaled
    for the substep), mouse_x, mouse_y, pressed] on the state's device."""
    check_supported(config)
    active = state.active_mask()
    x, y = state.x, state.y
    cand = grid.build_candidates(x, y, state.radius, active,
                                 cell_size(config, state))
    if config.solver == "colored":
        if config.pipeline == "sorted":
            sc, so = grid.sort_map(*grid.build_cell_ids(cand),
                                   impl=config.sort_impl)
            table = collision.occupants_from_sorted(sc, so,
                                                    config.max_occupancy)
        else:
            table = collision.occupants_from_buckets(
                grid.build_buckets(cand, config), config)
        x, y = collision.solve_colored(x, y, state.radius, table,
                                       f32(config.stiffness))
        overflow = table.overflow
    else:  # jacobi
        home = grid.build_buckets(cand, config, home_only=True)
        x, y = collision.solve_jacobi(x, y, state.radius, home, cand,
                                      config, active)
        overflow = home.overflow
    nx, ny, npx, npy = verlet_integrate(x, y, state.px, state.py,
                                        state.radius, active, prm, config)
    return state.replace(x=nx, y=ny, px=npx, py=npy,
                         overflow_count=state.overflow_count + overflow)


def step_fn(state: ParticleState, prm: torch.Tensor, config: SimConfig,
            resort_now: bool) -> ParticleState:
    """One frame: the Morton resort when the caller says it is due
    (``resort_now``; the Engine keeps the cadence on the host), then
    ``config.substeps`` passes."""
    if resort_now:
        state, _ = resort.morton_resort(state, cell_size(config, state),
                                        sort_impl=config.sort_impl)
    for _ in range(config.substeps):
        state = substep(state, prm, config)
    return state.replace(steps_since_sort=state.steps_since_sort + 1)


def make_step(config: SimConfig) -> Callable[..., ParticleState]:
    """``step_fn`` bound to ``config``: (state, prm, resort_now) -> state."""
    def step(state: ParticleState, prm: torch.Tensor,
             resort_now: bool) -> ParticleState:
        return step_fn(state, prm, config, resort_now)
    return step
