"""Particle state and per-step inputs (``gpu_physics_engine_tpu.core.state``).

``ParticleState`` keeps the JAX package's field names and dtypes: x/y/px/py
and radius as f32 planes of static length ``config.capacity`` (slots at
and past ``num_active`` are inactive, radius 0), color f32 [cap, 4] or
[cap, 0], and 0-d tensors on the same device for the counters and
max_radius, so a step never reads a value back to the host.

``StepParams`` holds plain Python floats on the host; ``as_tensor`` builds
the f32 ``[dt, mouse_x, mouse_y, pressed]`` vector that the step reads
from device memory.  The engines cache that tensor per distinct value, so
a step never copies the mouse state to the device (or waits for it)
unless the state changed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import SimConfig


@dataclasses.dataclass(frozen=True)
class StepParams:
    dt: float
    mouse_x: float = 0.0
    mouse_y: float = 0.0
    mouse_pressed: float = 0.0  # 1.0 while held

    @staticmethod
    def make(dt: float, mouse=(0.0, 0.0), pressed: bool = False
             ) -> "StepParams":
        return StepParams(dt=float(dt), mouse_x=float(mouse[0]),
                          mouse_y=float(mouse[1]),
                          mouse_pressed=1.0 if pressed else 0.0)

    def as_tensor(self, device, dt_scale: float = 1.0) -> torch.Tensor:
        """f32[4] = [dt * dt_scale, mouse_x, mouse_y, pressed] on ``device``
        (the product rounded in f32, as the JAX package computes it)."""
        dt = np.float32(self.dt) * np.float32(dt_scale)
        vals = np.array([dt, self.mouse_x, self.mouse_y, self.mouse_pressed],
                        np.float32)
        return torch.from_numpy(vals).to(device)


class ParamCache:
    """``params.as_tensor(device, dt_scale)`` built once per distinct
    StepParams, so an engine's steps never copy the mouse state to the
    device unless it changed (at most 64 kept)."""

    def __init__(self, device, dt_scale: float):
        self.device = device
        self.dt_scale = dt_scale
        self._cache = {}

    def __call__(self, params: StepParams) -> torch.Tensor:
        prm = self._cache.get(params)
        if prm is None:
            if len(self._cache) > 64:
                self._cache.clear()
            prm = params.as_tensor(self.device, self.dt_scale)
            self._cache[params] = prm
        return prm


FLOAT_FIELDS = ("x", "y", "px", "py", "radius", "color")
SCALAR_FIELDS = {"num_active": torch.int32, "steps_since_sort": torch.int32,
                 "max_radius": torch.float32, "overflow_count": torch.int32}


@dataclasses.dataclass
class ParticleState:
    """SoA particle state; every array has leading dim ``capacity``."""
    x: torch.Tensor              # f32[cap] current position x
    y: torch.Tensor              # f32[cap]
    px: torch.Tensor             # f32[cap] previous position x (Verlet)
    py: torch.Tensor             # f32[cap]
    radius: torch.Tensor         # f32[cap]; 0 marks an inactive slot
    color: torch.Tensor          # f32[cap, 4] or f32[cap, 0]
    num_active: torch.Tensor     # i32[] live particle count
    steps_since_sort: torch.Tensor  # i32[] steps since the Morton resort
    max_radius: torch.Tensor     # f32[] largest live radius -> cell size
    overflow_count: torch.Tensor  # i32[] occupants past K, summed

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def active_mask(self) -> torch.Tensor:
        """bool[cap], True for live slots (no host read)."""
        idx = torch.arange(self.capacity, dtype=torch.int32,
                           device=self.device)
        return idx < self.num_active

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)


def _color_shape(config: SimConfig):
    return (config.capacity, 4 if config.track_colors else 0)


def _scalars(device, num_active: int, max_radius: float) -> dict:
    def t(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)
    return dict(num_active=t(int(num_active), torch.int32),
                steps_since_sort=t(0, torch.int32),
                max_radius=t(float(np.float32(max_radius)), torch.float32),
                overflow_count=t(0, torch.int32))


def zeros(config: SimConfig, device=None) -> ParticleState:
    """An empty state at full capacity (all slots inactive)."""
    device = torch.device(device or "cpu")
    cap = config.capacity

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return ParticleState(x=z(cap), y=z(cap), px=z(cap), py=z(cap),
                         radius=z(cap), color=z(*_color_shape(config)),
                         **_scalars(device, 0, config.initial_radius))


def init_uniform(config: SimConfig, generator: torch.Generator,
                 device=None) -> ParticleState:
    """Initial scene: ``initial_particles`` uniform in [0, W) x [0, H), at
    rest, radius ``initial_radius``; random colors in [0, 1) when tracked.
    The numbers come from ``generator`` (a CPU torch.Generator), so they
    are not the JAX package's (compare states through ``from_numpy``)."""
    device = torch.device(device or "cpu")
    cap = config.capacity
    n = config.initial_particles
    active = torch.arange(cap) < n
    x = torch.rand(cap, generator=generator) * np.float32(config.world_width)
    y = torch.rand(cap, generator=generator) * np.float32(config.world_height)
    x = torch.where(active, x, 0.0)
    y = torch.where(active, y, 0.0)
    color = torch.rand(_color_shape(config), generator=generator)
    radius = torch.where(active, float(np.float32(config.initial_radius)),
                         0.0)
    x, y, radius, color = (a.to(device) for a in (x, y, radius, color))
    return ParticleState(x=x, y=y, px=x.clone(), py=y.clone(), radius=radius,
                         color=color,
                         **_scalars(device, n, config.initial_radius))


def from_arrays(config: SimConfig, positions, radii, previous_positions=None,
                colors=None, device=None) -> ParticleState:
    """A state from explicit arrays (the test-fixture path)."""
    device = torch.device(device or "cpu")
    positions = np.asarray(positions, np.float32).reshape(-1, 2)
    radii = np.asarray(radii, np.float32).reshape(-1)
    n = positions.shape[0]
    assert radii.shape[0] == n
    if previous_positions is None:
        previous_positions = positions
    prev = np.asarray(previous_positions, np.float32).reshape(-1, 2)
    cap = config.capacity
    assert n <= cap, f"{n} particles exceed capacity {cap}"

    def pad(a):
        out = np.zeros(cap, np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    color = np.zeros(_color_shape(config), np.float32)
    if colors is not None and config.track_colors:
        color[:n] = np.asarray(colors, np.float32)
    max_r = float(radii.max()) if n else config.initial_radius
    return ParticleState(
        x=pad(positions[:, 0]), y=pad(positions[:, 1]),
        px=pad(prev[:, 0]), py=pad(prev[:, 1]), radius=pad(radii),
        color=torch.from_numpy(color).to(device),
        **_scalars(device, n, max_r))


def to_numpy(state: ParticleState) -> Dict[str, np.ndarray]:
    """Host copy of every field, keyed by the field names (the JAX
    package's ParticleState carries the same keys)."""
    return {f.name: getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(ParticleState)}


def from_numpy(arrays: Dict[str, np.ndarray], device=None) -> ParticleState:
    """ParticleState from host arrays keyed like ``to_numpy``'s output
    (also ``{f: np.asarray(getattr(jax_state, f))}`` of a JAX state)."""
    device = torch.device(device or "cpu")

    def t(name, dtype):
        a = np.array(arrays[name], dtype)  # a writable copy
        return torch.from_numpy(a).to(device)

    fields = {f: t(f, np.float32) for f in FLOAT_FIELDS}
    fields.update({f: t(f, np.int32 if d == torch.int32 else np.float32
                        ).reshape(()) for f, d in SCALAR_FIELDS.items()})
    return ParticleState(**fields)
