"""gpu_physics_engine_torch — the tiled 2D particle engine on PyTorch and CUDA.

A port of ``gpu_physics_engine_tpu`` (JAX/Pallas), which stays in the
repository as the reference.  Module names mirror the JAX package's:

  core/    SimConfig, StepParams, tuned tables, TiledEngine
  ops/     tiled.py (tile storage, plain tensor ops, sweeps, the step),
           tiled_kernels.py (wrappers of the Jacobi-path CUDA kernels +
           their plain versions), gs_tiled.py (the Gauss-Seidel solve as
           plain tensor ops), gs_kernels.py (the Gauss-Seidel rank and
           color kernels' wrappers + plain versions), _cuda.py (nvcc
           build + ctypes binding)
  csrc/    the CUDA C++ kernels (sm_90a)
  utils/   FrameTimer

This package imports torch and numpy, never jax.
"""

from __future__ import annotations

from typing import Optional

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.state import StepParams
from gpu_physics_engine_torch.core.tiled_engine import (TiledEngine,
                                                        default_device)
from gpu_physics_engine_torch.core.tuned import (tuned_chunk, tuned_config,
                                                 tuned_row)

__version__ = "0.1.0"


def make_engine(config: SimConfig, seed: int = 0, device=None):
    """The engine for config.pipeline; only "tiled" is ported.  Runs on the
    CUDA card unless ``device`` says otherwise (raises without a card)."""
    if config.pipeline != "tiled":
        raise NotImplementedError(
            f"pipeline={config.pipeline!r} is not ported yet (ROADMAP.md "
            "queue 1, item 9: array pipelines)")
    return TiledEngine(config, seed=seed, device=default_device(device))


def make_tuned_engine(n_particles: int, seed: int = 0,
                      device: Optional[str] = None, **overrides):
    """Production tiled engine at the swept geometry for this size
    (core/tuned.py); overrides go to SimConfig.  Runs on the CUDA card
    unless ``device`` says otherwise (raises without a card)."""
    cfg = tuned_config(n_particles, **overrides)
    return TiledEngine(cfg, seed=seed, chunk=tuned_chunk(n_particles),
                       device=default_device(device))


__all__ = ["SimConfig", "StepParams", "TiledEngine", "make_engine",
           "make_tuned_engine", "tuned_config", "tuned_chunk", "tuned_row",
           "__version__"]
