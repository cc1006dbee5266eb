"""Stable key/value sorting (``gpu_physics_engine_tpu.ops.sort``).

Keys are u32 values held in int64 tensors (ops/morton), so they sort as
unsigned and the UNUSED sentinel 0xFFFFFFFF sinks to the end.

  * ``impl="lax"``: ``torch.sort(stable=True)``, the counterpart of the
    JAX package's ``jax.lax.sort(is_stable=True)`` (a library sort on
    both sides);
  * ``impl="radix"``: the hand LSD radix sort of ops/radix_sort: one
    CUDA kernel counts the four digit histograms, then each pass is one
    CUDA kernel (``radix_onesweep``: stable ranks, a decoupled look-back
    for the tile's offsets, and the store).

Both are stable, so equal cell ids keep ascending object order, and their
outputs are equal.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gpu_physics_engine_torch.ops.radix_sort import radix_sort_pairs

__all__ = ["sort_pairs", "argsort_u32"]


def sort_pairs(keys: torch.Tensor, payload: torch.Tensor,
               impl: str = "lax") -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort of the u32 ``keys`` (int64 tensor); the
    payload follows its key."""
    assert keys.dtype == torch.int64
    if impl == "radix":
        return radix_sort_pairs(keys, payload)
    sk, idx = torch.sort(keys, stable=True)
    return sk, payload[idx]


def argsort_u32(keys: torch.Tensor, impl: str = "lax"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted_keys, permutation i32) for u32 keys, stable."""
    iota = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    return sort_pairs(keys, iota, impl=impl)
