"""Frame timing + end-of-run summary (``gpu_physics_engine_tpu.utils.timer``).

Host wall clock only: on a CUDA device ``get_delta`` measures how fast the
host enqueues steps unless the caller synchronises.  Device times come from
CUDA events (chip_smoke.py).
"""

from __future__ import annotations

import time


class FrameTimer:
    def __init__(self):
        self.frame_count = 0
        self.total_time = 0.0
        self._last = None

    def start(self):
        self._last = time.perf_counter()
        return self

    def get_delta(self, frames: int = 1) -> float:
        """Seconds since the previous call; ``frames`` is how many steps
        the elapsed time covers."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return 0.0
        dt = now - self._last
        self._last = now
        self.frame_count += max(int(frames), 1)
        self.total_time += dt
        return dt

    @property
    def average_ms(self) -> float:
        return 1e3 * self.total_time / max(self.frame_count, 1)

    @property
    def fps(self) -> float:
        return self.frame_count / self.total_time if self.total_time else 0.0

    def summary(self) -> str:
        return (f"Average update time: {self.average_ms:.3f} ms | "
                f"FPS: {self.fps:.1f} | frames: {self.frame_count} | "
                f"total: {self.total_time:.2f} s")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        print(self.summary())
        return False
