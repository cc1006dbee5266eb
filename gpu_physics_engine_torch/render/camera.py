"""2D orthographic camera with pan and zoom-to-cursor, a copy of
``gpu_physics_engine_tpu.render.camera`` (host numpy, float64).

The analog of the reference's camera (src/renderer/camera.rs): auto-fit
zoom at 90% of the window (camera.rs:30-42), WASD/arrow pan scaled by
1/zoom (camera.rs:137-143), wheel zoom anchored at the cursor
(camera.rs:145-166), ``screen_to_world`` (camera.rs:169-182), and the
column-major 4x4 view-projection matrix (camera.rs:202-221).  The viewer
takes ``world_rect`` (the device compositor's viewport) and
``world_to_screen`` (the host splat's transform).
"""

from __future__ import annotations

import numpy as np

ZOOM_MIN, ZOOM_MAX = 0.1, 100.0


class Camera:
    def __init__(self, world_size, screen_size=(1280, 720),
                 speed: float = 500.0, zoom_sensitivity: float = 0.1):
        self.world_size = (float(world_size[0]), float(world_size[1]))
        self.screen_size = (float(screen_size[0]), float(screen_size[1]))
        # centred on the world, zoomed to fit at 90% (camera.rs:24-42)
        self.position = np.array(
            [self.world_size[0] / 2.0, self.world_size[1] / 2.0], np.float64)
        zx = self.screen_size[0] / self.world_size[0]
        zy = self.screen_size[1] / self.world_size[1]
        self.zoom = min(zx, zy) * 0.9
        self.speed = speed
        self.zoom_sensitivity = zoom_sensitivity
        # controller state (CameraController, camera.rs:227-288)
        self.pressed = {"up": False, "down": False, "left": False,
                        "right": False}
        self.scroll_delta = 0.0
        self.mouse_position = (0.0, 0.0)

    # ---- input latching ----

    def move_camera(self, direction: str, is_pressed: bool):
        self.pressed[direction] = is_pressed

    def zoom_camera(self, scroll_delta: float):
        self.scroll_delta += float(scroll_delta)

    def set_mouse_position(self, screen_pos):
        self.mouse_position = (float(screen_pos[0]), float(screen_pos[1]))

    # ---- per-frame update (camera.rs:138-168) ----

    def update(self, dt: float):
        move = self.speed * dt / self.zoom
        if self.pressed["up"]:
            self.position[1] += move
        if self.pressed["down"]:
            self.position[1] -= move
        if self.pressed["right"]:
            self.position[0] += move
        if self.pressed["left"]:
            self.position[0] -= move

        if self.scroll_delta != 0.0:
            before = self.screen_to_world(self.mouse_position)
            self.zoom *= 1.0 + self.scroll_delta * self.zoom_sensitivity
            self.zoom = float(np.clip(self.zoom, ZOOM_MIN, ZOOM_MAX))
            after = self.screen_to_world(self.mouse_position)
            self.position += np.asarray(before) - np.asarray(after)
            self.scroll_delta = 0.0

    # ---- transforms ----

    def screen_to_world(self, screen_pos):
        """Pixel coords (top-left origin) -> world coords (camera.rs:169-182)."""
        sw, sh = self.screen_size
        ndc_x = (screen_pos[0] / sw) * 2.0 - 1.0
        ndc_y = 1.0 - (screen_pos[1] / sh) * 2.0
        half_w = sw / (2.0 * self.zoom)
        half_h = sh / (2.0 * self.zoom)
        return (self.position[0] + ndc_x * half_w,
                self.position[1] + ndc_y * half_h)

    def world_rect(self):
        """Visible world-space rect (x0, y0, x1, y1): the device
        compositor's viewport (render/device.py)."""
        half_w = self.screen_size[0] / (2.0 * self.zoom)
        half_h = self.screen_size[1] / (2.0 * self.zoom)
        return (float(self.position[0] - half_w),
                float(self.position[1] - half_h),
                float(self.position[0] + half_w),
                float(self.position[1] + half_h))

    def world_to_screen(self, world_xy: np.ndarray) -> np.ndarray:
        """[N, 2] world coords -> float pixel coords (top-left origin)."""
        p = (np.asarray(world_xy, np.float64) - self.position) * self.zoom
        sx = p[..., 0] + self.screen_size[0] / 2.0
        sy = self.screen_size[1] / 2.0 - p[..., 1]
        return np.stack([sx, sy], axis=-1)

    def view_proj(self) -> np.ndarray:
        """Column-major 4x4 ortho view-projection (CameraUniform,
        camera.rs:202-221): world -> clip space [-1, 1]^2."""
        half_w = self.screen_size[0] / (2.0 * self.zoom)
        half_h = self.screen_size[1] / (2.0 * self.zoom)
        m = np.zeros((4, 4), np.float32)
        m[0, 0] = 1.0 / half_w
        m[1, 1] = 1.0 / half_h
        m[2, 2] = -1.0
        m[3, 3] = 1.0
        m[0, 3] = -self.position[0] / half_w
        m[1, 3] = -self.position[1] / half_h
        return m.T.copy()  # column-major storage
