"""Production tile geometry per particle count: a copy of the tables in
``gpu_physics_engine_tpu.core.tuned``.

The rows were chosen by long-horizon sweeps of the JAX package on its own
accelerator (method and evidence in that module and in PERF.md).  They are
data, copied so this package needs no jax; tests/test_torch_config.py holds
them equal to the originals.  Whether they are also the best rows for this
port's device is an open measurement (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

from gpu_physics_engine_torch.core.config import SimConfig

TUNED_NEWTON = True

# n_particles -> (tile_multiplier, tile_cap, run chunk, tiled_match,
#                 tiled_relocate_interval)
TUNED_TILE_GEOMETRY = {
    100_000: (22.0, 10, 128, "greedy", 2),
    256_000: (12.1, 9, 128, "greedy", 2),
    512_000: (6.6, 7, 128, "greedy", 4),
    756_000: (4.4, 5, 32, "greedy", 4),
    1_048_576: (4.4, 6, 32, "greedy", 4),
    2_000_000: (4.4, 6, 16, "greedy", 4),
    3_000_000: (4.4, 6, 16, "greedy", 4),
    4_194_304: (3.3, 8, 32, "greedy", 2),
}

# Per-row quality bounds: (deferred population %, stale-pair %).
QUALITY_EXPECTATION = {
    100_000: (0.6, 0.8),
    256_000: (1.2, 1.5),
    512_000: (1.6, 2.8),
    756_000: (1.2, 1.0),
    1_048_576: (1.0, 1.0),
    2_000_000: (1.4, 1.0),
    3_000_000: (4.5, 1.7),
    4_194_304: (1.0, 1.0),
}

# Per-size overrides beyond the geometry tuple: the wholesale rebuild sweep
# at the small sizes, hysteresis off at 4M.
TUNED_OVERRIDES = {
    100_000: dict(tiled_sweep="rebuild"),
    256_000: dict(tiled_sweep="rebuild"),
    512_000: dict(tiled_sweep="rebuild"),
    4_194_304: dict(tiled_hysteresis=0.0),
}

# Reference-exact Gauss-Seidel storage cap per size (tiled_solver="gs").
_GS_CAP = {100_000: 3, 256_000: 4, 512_000: 4, 756_000: 4,
           1_048_576: 4, 2_000_000: 5, 3_000_000: 6, 4_194_304: 6}

GS_FLAGS: dict = {}

_GS_SWEEP: dict = {}


def _nearest(table, n_particles: int) -> int:
    """Log-nearest swept size (the optimum tracks density, which scales
    with n)."""
    return min(sorted(table), key=lambda s: abs(s / n_particles - 1.0)
               + abs(n_particles / s - 1.0))


def GS_SWEEP(n_particles: int):
    """(sort_interval_steps, tiled_sweep) for the GS solver at n."""
    return _GS_SWEEP.get(_nearest(_GS_CAP, n_particles), (240, "relocate"))


def GS_TUNED(n_particles: int):
    """(tile_cap, tiled_match) for the GS solver at n."""
    return _GS_CAP[_nearest(_GS_CAP, n_particles)], "auto"


def tuned_overrides(n_particles: int) -> dict:
    return dict(TUNED_OVERRIDES.get(
        _nearest(TUNED_TILE_GEOMETRY, n_particles), {}))


def tuned_row(n_particles: int):
    """(mult, cap, chunk, match, interval) for the nearest swept size."""
    return TUNED_TILE_GEOMETRY[_nearest(TUNED_TILE_GEOMETRY, n_particles)]


def tuned_config(n_particles: int, max_particles: Optional[int] = None,
                 **overrides) -> SimConfig:
    """Production tiled SimConfig at the swept geometry for this size;
    ``overrides`` go straight to SimConfig and win over the table."""
    mult, cap, _, match, iv = tuned_row(n_particles)
    kw = dict(pipeline="tiled", tile_multiplier=mult, tile_cap=cap,
              tiled_match=match, tiled_relocate_interval=iv,
              tiled_uniform_radius=True,
              tiled_newton=TUNED_NEWTON,
              initial_particles=n_particles,
              max_particles=max_particles or n_particles)
    kw.update(tuned_overrides(n_particles))
    kw.update(overrides)
    return SimConfig(**kw)


def tuned_chunk(n_particles: int) -> int:
    """run() window depth paired with tuned_config."""
    return tuned_row(n_particles)[2]


def gs_config(n_particles: int, **overrides) -> SimConfig:
    """The reference-exact Gauss-Seidel configuration at this size, as the
    JAX package's bench builds it (bench.py measure_gs): tiles are the
    reference's cells (multiplier 2.2), the GS_TUNED storage cap, K = 8,
    uniform radius, the GS_SWEEP cadence.  ``overrides`` win."""
    cap, match = GS_TUNED(n_particles)
    sweep_iv, sweep_mech = GS_SWEEP(n_particles)
    kw = dict(max_particles=n_particles, initial_particles=n_particles,
              pipeline="tiled", tiled_solver="gs", tile_multiplier=2.2,
              tile_cap=cap, max_occupancy=8, tiled_uniform_radius=True,
              tiled_match=match, sort_interval_steps=sweep_iv,
              tiled_sweep=sweep_mech, **GS_FLAGS)
    kw.update(overrides)
    return SimConfig(**kw)
