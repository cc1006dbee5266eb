"""Velocity colormap: blue -> pink -> yellow two-stage smoothstep ramp
(``gpu_physics_engine_tpu.render.colormap``, kept as a copy: the port
imports nothing of the JAX package).

Exact replication of the reference vertex shader's get_particle_color
(particle_drawer.wgsl:39-67): normalized |v| / MAX_VELOCITY(0.3) clamped to
[0,1], mixed blue(0,0,1) -> pink(1,0.5,1) over smoothstep(0,0.5) then ->
yellow(1,1,0) over smoothstep(0.5,1).  The static per-particle color field
is deliberately ignored, as in the reference drawer.
"""

from __future__ import annotations

import numpy as np

MAX_VELOCITY = 0.3
COLOR_LOW = np.array([0.0, 0.0, 1.0], np.float32)   # blue (slowest)
COLOR_MID = np.array([1.0, 0.5, 1.0], np.float32)   # pink
COLOR_HIGH = np.array([1.0, 1.0, 0.0], np.float32)  # yellow (fastest)


def smoothstep(e0: float, e1: float, x: np.ndarray) -> np.ndarray:
    t = np.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def velocity_colors(velocities: np.ndarray) -> np.ndarray:
    """[N, 2] velocities -> [N, 3] RGB in [0, 1]."""
    v = np.linalg.norm(np.asarray(velocities, np.float32), axis=-1)
    t = np.clip(v / MAX_VELOCITY, 0.0, 1.0)
    s1 = smoothstep(0.0, 0.5, t)[:, None]
    s2 = smoothstep(0.5, 1.0, t)[:, None]
    color = COLOR_LOW * (1.0 - s1) + COLOR_MID * s1
    color = color * (1.0 - s2) + COLOR_HIGH * s2
    return color.astype(np.float32)
