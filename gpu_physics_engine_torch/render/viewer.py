"""Host viewer (``gpu_physics_engine_tpu.render.viewer``): composes a frame
from an engine.

The analog of the reference Renderer (src/renderer/renderer.rs:27-75):
clear to black, draw the particles as velocity-colored soft circles and,
with the `G` toggle, the grid lines, present.  "Present" is a numpy RGB
frame, saved as a PNG or shown by app/interactive.py and app/web.py.

``render`` pulls positions, previous positions and radii to the host and
splats them with the C++ rasterizer (render/native/rasterizer.cpp; a
failed build raises).  ``render_engine`` takes the device path for
engines that draw their own frame (``TiledEngine.render_frame``: the
compositor runs on the engine's device and only the finished image is
downloaded) and the host splat for the others (the array Engine).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gpu_physics_engine_torch.render import colormap, lines, rasterizer
from gpu_physics_engine_torch.render.camera import Camera
from gpu_physics_engine_torch.utils.png import write_png

CLEAR_COLOR = (0.0, 0.0, 0.0)  # black clear (renderer.rs:40-47)


class Viewer:
    def __init__(self, world_size: Tuple[float, float],
                 screen_size: Tuple[int, int] = (1280, 720)):
        self.camera = Camera(world_size, screen_size)
        self.screen_size = (int(screen_size[0]), int(screen_size[1]))
        self.world_size = world_size
        self.draw_grid = False  # `G` toggle (grid.rs:345-351)

    def toggle_grid(self):
        self.draw_grid = not self.draw_grid

    def resize(self, screen_size: Tuple[int, int]):
        """Window resize (SurfaceManager::resize, surface_manager.rs)."""
        self.screen_size = (int(screen_size[0]), int(screen_size[1]))
        self.camera.screen_size = (float(screen_size[0]),
                                   float(screen_size[1]))

    def _grid(self, frame: np.ndarray, cell_size: float) -> None:
        """The grid lines over ``frame`` (y-down screen: a vertical
        segment's endpoints swap, hence min and max)."""
        a, b, hz = lines.grid_line_segments(self.world_size, cell_size)
        sa = self.camera.world_to_screen(a)
        sb = self.camera.world_to_screen(b)
        rgb = np.tile(np.asarray(lines.GRID_COLOR, np.float32), (len(a), 1))
        rasterizer.draw_axis_lines(frame, np.minimum(sa, sb),
                                   np.maximum(sa, sb), rgb, hz)

    def render(self, positions: np.ndarray, previous_positions: np.ndarray,
               radii: np.ndarray,
               cell_size: Optional[float] = None) -> np.ndarray:
        """Compose one frame on the host; returns (H, W, 3) float32 RGB."""
        w, h = self.screen_size
        frame = np.empty((h, w, 3), np.float32)
        frame[:] = CLEAR_COLOR
        if self.draw_grid and cell_size:
            self._grid(frame, cell_size)
        pos = np.asarray(positions, np.float32)
        if pos.shape[0]:
            screen = self.camera.world_to_screen(pos)
            sr = np.asarray(radii, np.float32) * self.camera.zoom
            rgb = colormap.velocity_colors(pos - np.asarray(previous_positions))
            rasterizer.splat(frame, screen[:, 0], screen[:, 1], sr, rgb)
        return frame

    def render_engine(self, engine, preview_scale: int = 1) -> np.ndarray:
        """One (H, W, 3) float32 frame of the engine.

        Engines with ``render_frame`` draw the frame on their device at the
        camera's world rect; only the u8 image is downloaded, and the grid
        lines are drawn over it on the host.  ``preview_scale`` s > 1
        draws at (w/s, h/s) and upscales on the host (nearest), the same
        world rect at s^2 fewer pixels.  Other engines are splatted on the
        host from their downloaded arrays."""
        if not hasattr(engine, "render_frame"):
            return self.render(engine.positions(), engine.previous_positions(),
                               engine.radii(), engine.cell_size())
        w, h = self.screen_size
        s = max(1, int(preview_scale))
        fw, fh = -(-w // s), -(-h // s)  # ceil: cover the window
        raw = engine.render_frame(rect=self.camera.world_rect(),
                                  width=fw, height=fh)
        frame = np.asarray(raw, np.float32) / 255.0
        if s > 1:
            frame = np.ascontiguousarray(
                frame.repeat(s, axis=0).repeat(s, axis=1)[:h, :w])
        cell = engine.cell_size()
        if self.draw_grid and cell:
            self._grid(frame, cell)
        return frame

    def save_png(self, path: str, frame: np.ndarray) -> None:
        write_png(path, frame)
