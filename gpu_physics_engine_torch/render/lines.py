"""Grid line segments (``gpu_physics_engine_tpu.render.lines``).

The reference's GridDrawer (src/grid/grid_drawer.rs:24-60) emits the
vertical and horizontal cell boundary lines, toggled with the `G` key.
Here they are world-space segments for the viewer's axis-aligned line
rasterizer (render/rasterizer.draw_axis_lines).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

GRID_COLOR = (0.25, 0.25, 0.25)


def grid_line_segments(world_size: Tuple[float, float], cell_size: float):
    """(a[N,2], b[N,2], horizontal[N]) world-space cell boundary lines."""
    w, h = world_size
    nx = int(math.ceil(w / cell_size)) + 1
    ny = int(math.ceil(h / cell_size)) + 1
    a, b, horiz = [], [], []
    for i in range(nx):
        x = i * cell_size
        a.append((x, 0.0))
        b.append((x, h))
        horiz.append(0)
    for j in range(ny):
        y = j * cell_size
        a.append((0.0, y))
        b.append((w, y))
        horiz.append(1)
    return (np.asarray(a, np.float32), np.asarray(b, np.float32),
            np.asarray(horiz, np.uint8))
