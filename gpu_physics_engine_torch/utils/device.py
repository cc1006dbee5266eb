"""The device an engine runs on (``gpu_physics_engine_tpu.utils.device``,
``device_info`` only).

The JAX package's platform is global (``force_cpu``, and a probe of its
accelerator's relay); this package takes ``device=`` per engine instead
(``core/tiled_engine.default_device``), so it has neither.
"""

from __future__ import annotations

import torch

from gpu_physics_engine_torch.core.tiled_engine import default_device


def device_info(device=None) -> dict:
    """{"backend", "device", "platform", "device_count"} of ``device``
    (default: the CUDA card, raising without one): on a card its name from
    torch, platform "gpu" and the number of cards; else the CPU."""
    dev = default_device(device)
    if dev.type == "cuda":
        return {"backend": "cuda",
                "device": torch.cuda.get_device_name(dev),
                "platform": "gpu",
                "device_count": torch.cuda.device_count()}
    return {"backend": dev.type, "device": str(dev), "platform": dev.type,
            "device_count": 1}
