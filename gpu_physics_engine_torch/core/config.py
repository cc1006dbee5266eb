"""Simulation configuration: a copy of ``gpu_physics_engine_tpu.core.config``.

The JAX package's module runs its package ``__init__`` (which imports jax)
on import, and the machine that runs this port has no jax, so the dataclass
is copied here field for field, with the same defaults, the same
``__post_init__`` checks and the same derived properties.  The drift tests
(tests/test_torch_config.py) hold the two copies equal.

Field meanings are documented at length in the JAX package's copy; the
comments here only say what each group is for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Sentinel cell id marking unused candidate slots; sorts last as uint32.
UNUSED_CELL_ID = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static parameters of a simulation (frozen, hashable)."""

    # --- world ---
    world_width: float = 3048.0
    world_height: float = 1048.0
    world_shape: str = "box"  # "box" clamp or inscribed "circle"

    # --- capacity ---
    max_particles: int = 1 << 20

    # --- physics ---
    gravity: Tuple[float, float] = (0.0, 0.0)
    dt: float = 1.0 / 60.0
    stiffness: float = 0.6
    mouse_strength: float = 150.0
    substeps: int = 1

    # --- broad phase (array pipelines) ---
    cell_size_multiplier: float = 2.2
    max_cells_per_object: int = 4
    max_occupancy: int = 8

    # --- solver/pipeline selection ---
    solver: str = "colored"
    pipeline: str = "sorted"
    sort_impl: str = "lax"
    fast_pack_bf16: bool = True

    # --- periodic sweep cadence ---
    sort_interval_steps: int = 240

    # --- initial scene ---
    initial_particles: int = 1 << 20
    initial_radius: float = 0.5

    # --- interactive spawn ---
    spawn_burst: int = 100
    spawn_radius_min: float = 1.0
    spawn_radius_max: float = 3.0

    track_colors: bool = False

    # --- persistent tiled pipeline (ops/tiled.py) ---
    tile_multiplier: float = 4.4
    tile_cap: int = 24              # slots per tile; 0 = auto from the scene
    mover_capacity: int = 1 << 15   # claim-relocate mover buffer
    sweep_mover_capacity: int = 0   # periodic sweep buffer; 0 = auto
    tiled_sweep: str = "relocate"   # "relocate" | "rebuild" | "bands"
    tiled_band_rows: int = 16
    tiled_band_k: int = 2
    tiled_rebuild_impl: str = "payload"
    tiled_rebuild_every: int = 0
    # backends: "pallas" = hand kernel, "jnp" = the plain tensor path,
    # "auto" = hand kernel on a CUDA tensor, plain version on a CPU tensor
    tiled_collide: str = "auto"
    tiled_relocate: str = "auto"
    tiled_hysteresis: float = -1.0  # tile-edge fraction; -1 = auto
    tiled_relocate_interval: int = 1
    tiled_drift_budget: float = -1.0  # world units per step; -1 = auto
    tiled_relocate_passes: int = 1
    tiled_solver: str = "sweep"     # "sweep" (Jacobi) | "gs"
    gs_layout: str = "auto"
    gs_mx_split: bool = True
    gs_rank: str = "auto"
    gs_par_fused: Optional[bool] = None
    gs_fuse_integrate: Optional[bool] = None
    gs_colors_mega: bool = False
    gs_relocate_mega: bool = False
    render_supersample: int = 1
    tiled_fuse_integrate: bool = True
    # the port computes the same pair set in the gather form either way
    # (csrc/tiled_kernels.cuh, K1's note): the flag changes the f32 sum
    # order of the JAX package's kernel only
    tiled_newton: bool = False
    tiled_uniform_radius: bool = False
    # storage-jam watchdog at run() boundaries
    tiled_watchdog: bool = True
    tiled_watchdog_pct: float = 2.0
    tiled_match: str = "auto"       # "flip" | "flip2" | "greedy" | "auto"
    tile_max_radius: float | None = None
    tiled_auto_cap_pct: float = 0.0
    tiled_spawn: str = "auto"
    big_capacity: int = 2048

    # --- multi-device ---
    mesh_axis: str = "shards"
    halo_capacity: int = 1024
    migration_capacity: int = 256

    def __post_init__(self):
        assert self.max_particles >= self.initial_particles
        assert self.solver in ("colored", "fast", "jacobi")
        assert self.pipeline in ("sorted", "bucket", "tiled")
        assert self.sort_impl in ("lax", "radix")
        assert self.tiled_match in ("flip", "flip2", "greedy", "auto")
        assert self.tiled_relocate_passes >= 1
        assert self.tiled_spawn in ("bigs", "retile", "auto")
        assert self.big_capacity >= 1
        assert self.tiled_solver in ("sweep", "gs")
        assert self.tiled_sweep in ("relocate", "rebuild", "bands")
        assert self.tiled_band_rows >= 2 and self.tiled_band_k >= 1
        assert self.tiled_rebuild_impl in ("payload", "gather")
        assert self.tiled_relocate_interval >= 1
        assert not (self.tiled_solver == "gs"
                    and self.tiled_relocate_interval > 1), (
            "the GS parity solver requires storage == home every step")
        assert self.gs_layout in ("auto", "dec", "flat", "mx", "par")
        assert self.gs_rank in ("auto", "minloop", "net")
        assert 1 <= self.render_supersample <= 4
        assert self.world_shape in ("box", "circle")
        assert self.max_cells_per_object == 4, "2D: home + 3 phantom cells"

    # ---- derived (static) quantities ----

    @property
    def capacity(self) -> int:
        return _round_up(self.max_particles, 1024)

    @property
    def tile_max_radius_effective(self) -> float:
        return (self.tile_max_radius if self.tile_max_radius is not None
                else self.initial_radius)

    @property
    def min_cell_size(self) -> float:
        return self.cell_size_multiplier * self.initial_radius

    @property
    def grid_dims(self) -> Tuple[int, int]:
        nx = int(math.ceil(self.world_width / self.min_cell_size)) + 2
        ny = int(math.ceil(self.world_height / self.min_cell_size)) + 2
        return nx, ny

    @property
    def num_cells(self) -> int:
        nx, ny = self.grid_dims
        return nx * ny

    def cell_size(self, max_radius: float) -> float:
        return self.cell_size_multiplier * max_radius

    @property
    def drift_budget(self) -> float:
        """Per-step staleness drift reserve in world units."""
        if self.tiled_drift_budget >= 0.0:
            return self.tiled_drift_budget
        return 0.15 * self.tile_max_radius_effective

    @property
    def hysteresis_delta(self) -> float:
        """Resolved pull-relocate hysteresis in world units: 0 when the
        geometry leaves no safe margin; (interval-1) steps of drift_budget
        are reserved so 2*(delta + (k-1)*drift) + 2*r_max <= tile_edge
        keeps holding."""
        t = self.tile_multiplier * self.tile_max_radius_effective
        d_max = (t - 2.0 * self.tile_max_radius_effective) / 2.0
        d_max -= (self.tiled_relocate_interval - 1) * self.drift_budget
        d_max = max(0.0, d_max)
        if self.tiled_hysteresis >= 0.0:
            d = self.tiled_hysteresis * t
        else:
            d = min(0.25 * t, 0.9 * d_max)
        return max(0.0, min(d, 0.95 * d_max))

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
