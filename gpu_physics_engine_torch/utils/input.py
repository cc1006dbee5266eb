"""Input mapping for the interactive apps (``gpu_physics_engine_tpu.utils.input``).

The analog of the reference's InputManager (src/utils/input_manager.rs:
12-63).  Keymap:

  Esc               quit
  P                 spawn a burst at the cursor (input_manager.rs:15-17)
  G                 toggle grid lines (input_manager.rs:18-20)
  W/A/S/D, arrows   pan the camera (input_manager.rs:21-47)

Mouse: move -> attractor position, left press/release -> attractor on/off,
wheel -> zoom at the cursor.  Framework-agnostic: the app feeds abstract
events, and this drives the engine and the viewer, as State::render_loop
forwards them (state.rs:87-90).
"""

from __future__ import annotations

from typing import Callable, Optional

_PAN_KEYS = {
    "w": "up", "arrowup": "up",
    "s": "down", "arrowdown": "down",
    "a": "left", "arrowleft": "left",
    "d": "right", "arrowright": "right",
}


class InputManager:
    def __init__(self, engine, viewer, on_quit: Optional[Callable] = None):
        self.engine = engine
        self.viewer = viewer
        self.on_quit = on_quit
        self._cursor_screen = (0.0, 0.0)

    # ---- keyboard ----

    def process_keyboard_input(self, key: str, pressed: bool):
        key = key.lower()
        if key in ("escape", "esc") and pressed:
            if self.on_quit:
                self.on_quit()
        elif key == "p" and pressed:
            self.engine.spawn_at(self._cursor_world())
        elif key == "g" and pressed:
            self.viewer.toggle_grid()
        elif key in _PAN_KEYS:
            self.viewer.camera.move_camera(_PAN_KEYS[key], pressed)

    # ---- mouse ----

    def process_cursor_moved(self, screen_pos):
        self._cursor_screen = (float(screen_pos[0]), float(screen_pos[1]))
        self.viewer.camera.set_mouse_position(self._cursor_screen)
        self.engine.move_mouse(self._cursor_world())

    def process_mouse_input(self, button: str, pressed: bool):
        if button != "left":
            return
        if pressed:
            self.engine.press_mouse(self._cursor_world())
        else:
            self.engine.release_mouse()

    def process_mouse_wheel(self, delta: float):
        self.viewer.camera.zoom_camera(delta)

    def _cursor_world(self):
        return self.viewer.camera.screen_to_world(self._cursor_screen)
