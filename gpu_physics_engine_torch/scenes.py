"""Scene presets (``gpu_physics_engine_tpu.scenes``): the five BASELINE.json
configurations as a SimConfig plus a script of timed events for the
headless runner (app/headless.py ``--scene``).

The reference hardcodes one scene (1M particles in a 3048x1048 world,
state.rs:35, particle_system.rs:28); BASELINE.json's configs define five
variants.  The configs equal the JAX package's field by field
(tests/test_torch_apps.py); ``four_million`` comes from this package's
``core/tuned.tuned_config``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.tuned import tuned_config


@dataclasses.dataclass(frozen=True)
class SceneEvent:
    step: int
    kind: str          # "press" | "release" | "spawn"
    pos: Tuple[float, float] = (0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    description: str
    config: SimConfig
    steps: int
    events: Tuple[SceneEvent, ...] = ()


_WORLD = dict(world_width=3048.0, world_height=1048.0)
_CENTER = (1524.0, 524.0)


def _scenes() -> Dict[str, Scene]:
    return {
        # config 1: the reference scene at a size the CPU runs
        "tiny": Scene(
            name="tiny",
            description="10k particles, gravity off, bounded box, 600 steps",
            config=SimConfig(max_particles=10_000, initial_particles=10_000,
                             **_WORLD),
            steps=600),
        # config 2: interaction-heavy
        "interactive": Scene(
            name="interactive",
            description="100k with gravity, scripted attractor, spawn bursts",
            config=SimConfig(max_particles=101_000, initial_particles=100_000,
                             gravity=(0.0, -98.0), **_WORLD),
            steps=600,
            events=tuple(
                [SceneEvent(100, "press", _CENTER),
                 SceneEvent(400, "release")] +
                [SceneEvent(200 + 40 * i, "spawn", _CENTER) for i in range(10)])),
        # config 3: the reference headline scene on the array Engine
        # (solver="fast"; Morton resort every 4 sim-seconds at 60 steps/s)
        "million": Scene(
            name="million",
            description="1M particles, Morton resort every 4 sim-seconds",
            config=SimConfig(max_particles=1 << 20, initial_particles=1 << 20,
                             sort_interval_steps=240, solver="fast", **_WORLD),
            steps=600),
        # config 4: sustained scale with substeps on the tiled engine at the
        # tuned 4M geometry; substeps=2 runs K1 twice a step at dt_scale 0.5
        "four_million": Scene(
            name="four_million",
            description="4M sustained, multi-substep collision solve",
            config=tuned_config(4_194_304, substeps=2, solver="fast",
                                **_WORLD),
            steps=200),
        # config 5: 16M in a world of twice the edges, on one card (the JAX
        # package runs it sharded over a mesh as well; this package has no
        # multi-device path yet)
        "sixteen_million": Scene(
            name="sixteen_million",
            description="16M on one card, tiled pipeline, cap 8",
            config=SimConfig(max_particles=16_777_216,
                             initial_particles=16_777_216,
                             pipeline="tiled", tile_cap=8,
                             tile_multiplier=3.3,
                             world_width=2.0 * 3048.0, world_height=2.0 * 1048.0),
            steps=100),
    }


SCENES: Dict[str, Scene] = _scenes()


def get_scene(name: str) -> Scene:
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; available: {sorted(SCENES)}")
    return SCENES[name]
