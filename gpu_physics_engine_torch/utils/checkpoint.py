"""Checkpoint / resume (``gpu_physics_engine_tpu.utils.checkpoint``).

The JAX package's file format, so a checkpoint written by either package
loads in the other: one ``np.savez_compressed`` archive with
``__version__`` (int32 1), ``__config__`` (the JSON of
``dataclasses.asdict(config)`` as u8 bytes) and the arrays in the JAX
package's dtypes.

  * array engines: every ParticleState field under its own name;
  * the tiled engine (``__kind__`` = b"tiled"): the live particles by pid
    (``pid`` i32, ``positions``, ``previous_positions`` f32 [n, 2],
    ``radii`` f32 [n], ``overflow`` i32 []), not the tile layout: a load
    re-tiles them (``tiled.init_tiles``), so a load may change the
    geometry.  The big-particle overlay, when it holds particles, goes
    under ``big_pid``, ``big_positions``, ``big_previous``, ``big_radii``.

Loads build their tensors on the CUDA card unless ``device`` says
otherwise (without a card they raise, as the engines do).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np

from gpu_physics_engine_torch.core import state as state_lib
from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.state import ParticleState
from gpu_physics_engine_torch.core.tiled_engine import default_device
from gpu_physics_engine_torch.ops import bigs, tiled

_FORMAT_VERSION = 1


def _config_bytes(config: SimConfig) -> np.ndarray:
    return np.frombuffer(json.dumps(dataclasses.asdict(config)).encode(),
                         dtype=np.uint8)


def _stored_config(z) -> SimConfig:
    version = int(z["__version__"])
    assert version == _FORMAT_VERSION, f"unknown checkpoint version {version}"
    cfg = json.loads(bytes(z["__config__"].tobytes()).decode())
    cfg["gravity"] = tuple(cfg["gravity"])
    return SimConfig(**cfg)


def _assert_tiled(z) -> None:
    assert bytes(z["__kind__"].tobytes()) == b"tiled", "not a tiled checkpoint"


def save_checkpoint(path: str, state: ParticleState,
                    config: SimConfig) -> None:
    """An array engine's state and config (resume with
    ``Engine(config, initial_state=state)``)."""
    np.savez_compressed(path, __version__=np.int32(_FORMAT_VERSION),
                        __config__=_config_bytes(config),
                        **state_lib.to_numpy(state))


def load_checkpoint(path: str, device=None
                    ) -> Tuple[ParticleState, SimConfig]:
    """(state, config) of an array checkpoint."""
    with np.load(path) as z:
        config = _stored_config(z)
        arrays = {f.name: z[f.name]
                  for f in dataclasses.fields(ParticleState)}
    state = state_lib.from_numpy(arrays, device=default_device(device))
    return state, config


def save_tiled_checkpoint(path: str, state: tiled.TileState,
                          config: SimConfig, big=None) -> None:
    """The tile particles by pid, and the overlay ``big``'s live
    particles (oversized spawns live there, not in the tiles)."""
    pid, pos, prev, rad = tiled.export_particles(state)
    extra = {}
    if big is not None:
        bpid, bpos, bprev, brad = bigs.export_bigs(big)
        if len(bpid):
            extra = dict(big_pid=bpid, big_positions=bpos,
                         big_previous=bprev, big_radii=brad)
    np.savez_compressed(
        path, __version__=np.int32(_FORMAT_VERSION),
        __kind__=np.frombuffer(b"tiled", dtype=np.uint8),
        __config__=_config_bytes(config), pid=pid, positions=pos,
        previous_positions=prev, radii=rad,
        overflow=state.overflow_count.cpu().numpy(), **extra)


def peek_tiled_config(path: str) -> SimConfig:
    """The stored SimConfig, without building any state."""
    with np.load(path) as z:
        _assert_tiled(z)
        return _stored_config(z)


def load_tiled_bigs(path: str):
    """(pids, positions, previous positions, radii) of the stored overlay,
    or None when the checkpoint has none."""
    with np.load(path) as z:
        if "big_pid" not in z:
            return None
        return (z["big_pid"], z["big_positions"], z["big_previous"],
                z["big_radii"])


def load_tiled_checkpoint(path: str, config: SimConfig | None = None,
                          device=None) -> Tuple[tiled.TileState, SimConfig]:
    """(state, config): the stored particles re-tiled under ``config``
    (default: the stored one), with the stored overflow count added."""
    device = default_device(device)
    with np.load(path) as z:
        _assert_tiled(z)
        if config is None:
            config = _stored_config(z)
        state = tiled.init_tiles(
            config, z["positions"], z["radii"], pids=z["pid"],
            previous_positions=z["previous_positions"], device=device)
        overflow = int(z["overflow"])
    state = state.replace(overflow_count=state.overflow_count + overflow)
    return state, config
