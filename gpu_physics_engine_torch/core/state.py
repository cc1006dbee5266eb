"""Per-step dynamic inputs (``gpu_physics_engine_tpu.core.state.StepParams``).

Plain Python floats on the host; ``as_tensor`` builds the f32
``[dt, mouse_x, mouse_y, pressed]`` vector that the fused collide +
integrate kernel reads from device memory.  The engine caches that tensor
per distinct value, so a step never copies the mouse state to the device
(or waits for it) unless the state changed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
