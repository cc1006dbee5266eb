"""Stable LSD radix sort of u32 keys with one payload
(``gpu_physics_engine_tpu.ops.radix_sort``), with its rank/histogram pass
as a hand kernel.

Pass p (8-bit digit at shift 8p), as in the JAX package:
  1. ``rank_hist``: per 1024-key block, each key's stable rank among the
     block's keys with the same digit, and the block's 256-bin histogram;
  2. the global digit offsets: an exclusive scan of the histograms in
     (digit, block) order, digits major and blocks minor, so that equal
     digits keep block order;
  3. dest = offset[block, digit] + rank, a permutation of [0, n): scatter
     its inverse once, then gather keys and payload through it.
Steps 2 and 3 are plain PyTorch (XLA computes them in the JAX package).
Stability across passes gives ascending original index among equal keys,
the order ``torch.sort(stable=True)`` gives.  Keys travel through the
passes as the int32 view of their u32 bits; the caller's int64 keys come
back as int64.

K12 ``rank_hist`` replaces ``_rank_hist`` (gpu_physics_engine_tpu/ops/
radix_sort.py:80, kernel ``_rank_hist_kernel`` :51), CUDA C++ in
csrc/radix_kernels.cuh (bound and design there).  The wrapper launches it
for a CUDA tensor, runs the plain version (``rank_hist_plain``) for a CPU
tensor and raises for anything else; there is no fallback from a CUDA
tensor.  It adds one to ``LAUNCHES["radix_rank_hist"]`` per launch.  The
TPU kernel's [nblocks * 8, 256] histogram is a Mosaic tiling artifact;
here it is [nblocks, 256].
"""

from __future__ import annotations

from typing import Tuple

import torch

from gpu_physics_engine_torch.ops import _cuda
from gpu_physics_engine_torch.ops.tiled_kernels import _stream

BLOCK = 1024
BINS = 256
SENTINEL = -1  # the int32 view of 0xFFFFFFFF: sorts last as u32

LAUNCHES = {"radix_rank_hist": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def as_i32_bits(keys: torch.Tensor) -> torch.Tensor:
    """int32 tensor with the bits of the u32 values held in ``keys``
    (int64, 0 .. 0xFFFFFFFF)."""
    return torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(torch.int32)


def from_i32_bits(bits: torch.Tensor) -> torch.Tensor:
    """The u32 values (int64) of an int32 bit view."""
    return bits.to(torch.int64) & 0xFFFFFFFF


def digits(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """(key >> shift) & 255 of the u32 bits in the int32 ``keys``: the
    arithmetic shift fills bits that the mask drops."""
    return (keys >> shift) & (BINS - 1)


def rank_hist(keys: torch.Tensor, shift: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable in-block digit ranks i32 [n] and block histograms i32
    [n // BLOCK, BINS] of the int32 key bits ``keys`` (n a multiple of
    BLOCK)."""
    if keys.device.type == "cpu":
        return rank_hist_plain(keys, shift)
    return rank_hist_cuda(keys, shift)


def rank_hist_plain(keys: torch.Tensor, shift: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K12 (any device): a stable sort of
    block * 256 + digit; a key's rank is its place in its group."""
    n = keys.shape[0]
    nblocks = n // BLOCK
    block = torch.arange(n, device=keys.device) // BLOCK
    group = block * BINS + digits(keys, shift).to(torch.int64)
    hist = torch.bincount(group, minlength=nblocks * BINS)
    start = torch.cumsum(hist, 0) - hist
    order = torch.sort(group, stable=True)[1]
    rank = torch.empty(n, dtype=torch.int64, device=keys.device)
    rank[order] = torch.arange(n, device=keys.device) - start[group[order]]
    return rank.to(torch.int32), hist.view(nblocks, BINS).to(torch.int32)


def rank_hist_cuda(keys: torch.Tensor, shift: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K12 on the keys' CUDA device (raises for other tensors)."""
    if keys.device.type != "cuda":
        raise RuntimeError("radix rank_hist: the CUDA kernel needs a CUDA "
                           f"tensor, got {keys.device}")
    n = keys.shape[0]
    if (keys.dtype != torch.int32 or keys.dim() != 1
            or not keys.is_contiguous() or n % BLOCK or n == 0
            or n >= 2 ** 31):
        raise ValueError("radix rank_hist: keys must be a contiguous int32 "
                         f"[n], n a positive multiple of {BLOCK}; got "
                         f"{keys.dtype} {list(keys.shape)}")
    if shift not in (0, 8, 16, 24):
        raise ValueError(f"radix rank_hist: shift {shift} not in 0/8/16/24")
    nblocks = n // BLOCK
    rank = torch.empty(n, dtype=torch.int32, device=keys.device)
    hist = torch.empty((nblocks, BINS), dtype=torch.int32, device=keys.device)
    lib = _cuda.library()
    with torch.cuda.device(keys.device):
        rc = lib.gpe_radix_rank_hist(keys.data_ptr(), rank.data_ptr(),
                                     hist.data_ptr(), nblocks, shift,
                                     _stream(keys.device))
    _cuda.check(rc, "radix rank_hist")
    LAUNCHES["radix_rank_hist"] += 1
    return rank, hist


def one_pass(keys: torch.Tensor, payload: torch.Tensor, shift: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stable pass on the digit at ``shift`` (int32 key bits)."""
    n = keys.shape[0]
    nblocks = n // BLOCK
    rank, hist = rank_hist(keys, shift)
    flat = hist.t().reshape(-1).to(torch.int64)  # [digit, block]
    base = torch.cumsum(flat, 0) - flat
    block = torch.arange(n, device=keys.device) // BLOCK
    dest = base[digits(keys, shift) * nblocks + block] + rank
    inv = torch.empty(n, dtype=torch.int64, device=keys.device)
    inv[dest] = torch.arange(n, device=keys.device)
    return keys[inv], payload[inv]


def radix_sort_pairs(keys: torch.Tensor, payload: torch.Tensor,
                     num_bits: int = 32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort by the u32 ``keys`` (int64 tensor, values <
    2**num_bits) with one payload.  Pads to a BLOCK multiple with
    0xFFFFFFFF keys, which sort last."""
    n = keys.shape[0]
    if n == 0:
        return keys, payload
    pad = -n % BLOCK
    bits = as_i32_bits(keys)
    if pad:
        bits = torch.cat([bits, bits.new_full((pad,), SENTINEL)])
        payload = torch.cat([payload, payload.new_zeros(pad)])
    for p in range((num_bits + 7) // 8):
        bits, payload = one_pass(bits, payload, shift=8 * p)
    return from_i32_bits(bits[:n]), payload[:n]
