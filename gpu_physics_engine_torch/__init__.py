"""gpu_physics_engine_torch — the 2D particle engine on PyTorch and CUDA.

A port of ``gpu_physics_engine_tpu`` (JAX/Pallas), which stays in the
repository as the reference.  Module names mirror the JAX package's:

  core/    SimConfig, StepParams, ParticleState, tuned tables, TiledEngine
           (the tiled pipeline), Engine and stepper (the array pipelines:
           pipeline "sorted" or "bucket", solver "colored", "jacobi" or
           "fast")
  ops/     grid.py, sort.py, radix_sort.py (the hand radix sort: each
           pass is three CUDA kernels, the rank/histogram, the digit
           offsets and the scatter), collision.py, fast_solve.py (the
           sort + shift Jacobi solve), resort.py, spawn.py, morton.py, scan.py, integrate.py (the array
           pipelines' stages), tiled.py (tile storage, plain tensor ops,
           sweeps, spawn inserts, the step), bigs.py (the big-particle
           overlay for spawns too large for the tiles),
           tiled_kernels.py (wrappers of the Jacobi-path CUDA kernels +
           their plain versions), gs_tiled.py (the Gauss-Seidel solve as
           plain tensor ops), gs_kernels.py (the Gauss-Seidel rank and
           color kernels' wrappers + plain versions), gs_parity.py (the
           parity-space GS pipeline and the mx/dec solves, with their
           kernels' wrappers + plain versions), _cuda.py (nvcc build +
           ctypes binding), _native.py (g++ builds of the host C++: the
           overlay's rasterizer and init_tiles' spill pass,
           native/tiler.cpp)
  render/  device.py (the device compositor: TiledEngine.render_frame,
           step_render_frame, render_run), colormap.py (the velocity ramp),
           rasterizer.py (the host splat of the overlay's bigs)
  csrc/    the CUDA C++ kernels (sm_90a)
  utils/   FrameTimer, checkpoint.py (the JAX package's .npz format, both
           engines), profiling.py (where a step's time goes),
           kernel_study.py (K1 variants, the radix sort's pieces)

This package imports torch and numpy, never jax.

Every engine runs on the CUDA card unless given ``device="cpu"``; without
a card it raises.  On the CPU the kernel wrappers run their plain PyTorch
versions:

    from gpu_physics_engine_torch import SimConfig, make_engine
    cfg = SimConfig(max_particles=600, initial_particles=512,
                    world_width=64.0, world_height=32.0, sort_impl="radix")
    eng = make_engine(cfg, device="cpu")   # the array Engine
    eng.press_mouse((32.0, 16.0)); eng.run(20)

On the card, drop ``device``: ``sort_impl="radix"`` then launches K12.
"""

from __future__ import annotations

from typing import Optional

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.engine import Engine
from gpu_physics_engine_torch.core.state import ParticleState, StepParams
from gpu_physics_engine_torch.core.tiled_engine import (TiledEngine,
                                                        default_device)
from gpu_physics_engine_torch.core.tuned import (tuned_chunk, tuned_config,
                                                 tuned_row)

__version__ = "0.1.0"


def make_engine(config: SimConfig, seed: int = 0, device=None):
    """The engine for config.pipeline: TiledEngine for "tiled", the array
    Engine for "sorted"/"bucket".  Runs on the CUDA card unless ``device``
    says otherwise (raises without a card)."""
    if config.pipeline == "tiled":
        return TiledEngine(config, seed=seed, device=default_device(device))
    return Engine(config, seed=seed, device=default_device(device))


def make_tuned_engine(n_particles: int, seed: int = 0,
                      device: Optional[str] = None, **overrides):
    """Production tiled engine at the swept geometry for this size
    (core/tuned.py); overrides go to SimConfig.  Runs on the CUDA card
    unless ``device`` says otherwise (raises without a card)."""
    cfg = tuned_config(n_particles, **overrides)
    return TiledEngine(cfg, seed=seed, chunk=tuned_chunk(n_particles),
                       device=default_device(device))


__all__ = ["SimConfig", "StepParams", "ParticleState", "Engine",
           "TiledEngine", "make_engine",
           "make_tuned_engine", "tuned_config", "tuned_chunk", "tuned_row",
           "__version__"]
