"""Stable LSD radix sort of u32 keys with one payload
(``gpu_physics_engine_tpu.ops.radix_sort``), each of its passes three hand
kernels.

Pass p (8-bit digit at shift 8p), as in the JAX package:
  1. ``rank_hist``: per 1024-key block, each key's stable rank among the
     block's keys with the same digit, and the block's 256-bin histogram;
  2. ``digit_offsets``: the exclusive scan of the histograms in (digit,
     block) order, digits major and blocks minor, so that equal digits keep
     block order: offset[block, digit];
  3. ``scatter``: key and payload to offset[block, digit] + rank, a
     permutation of [0, n).
Stability across passes gives ascending original index among equal keys,
the order ``torch.sort(stable=True)`` gives.  Keys travel through the
passes as the int32 view of their u32 bits; the caller's int64 keys come
back as int64.

K12 ``rank_hist`` replaces ``_rank_hist`` (gpu_physics_engine_tpu/ops/
radix_sort.py:80, kernel ``_rank_hist_kernel`` :51); ``digit_offsets`` and
``scatter`` replace the XLA steps of that module's ``one_pass`` (:103-127:
the cumsum, and the scatter of the inverse permutation and its gathers).
All three are CUDA C++ in csrc/radix_kernels.cuh (bounds and designs
there).  Each wrapper launches its kernel for a CUDA tensor, runs its plain
version (``rank_hist_plain``, ``digit_offsets_plain``, ``scatter_plain``)
for a CPU tensor and raises for anything else; there is no fallback from a
CUDA tensor.  Each adds one to its ``LAUNCHES`` entry per call that
launches.  The TPU kernel's [nblocks * 8, 256] histogram is a Mosaic tiling
artifact; here it is [nblocks, 256].
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gpu_physics_engine_torch.ops import _cuda
from gpu_physics_engine_torch.ops.tiled_kernels import _stream

BLOCK = 1024
BINS = 256
SENTINEL = -1  # the int32 view of 0xFFFFFFFF: sorts last as u32
OFFSET_ROWS = 32  # key blocks per chunk of radix_offsets (kOffsetRows)

LAUNCHES = {"radix_rank_hist": 0, "radix_offsets": 0, "radix_scatter": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def as_i32_bits(keys: torch.Tensor) -> torch.Tensor:
    """int32 tensor with the bits of the u32 values held in ``keys``
    (int64, 0 .. 0xFFFFFFFF): the conversion keeps the low 32 bits."""
    return keys.to(torch.int32)


def from_i32_bits(bits: torch.Tensor) -> torch.Tensor:
    """The u32 values (int64) of an int32 bit view."""
    return bits.view(torch.uint32).to(torch.int64)


def digits(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """(key >> shift) & 255 of the u32 bits in the int32 ``keys``: the
    arithmetic shift fills bits that the mask drops."""
    return (keys >> shift) & (BINS - 1)


def _check_cuda_keys(what: str, keys: torch.Tensor) -> None:
    if keys.device.type != "cuda":
        raise RuntimeError(f"radix {what}: the CUDA kernel needs a CUDA "
                           f"tensor, got {keys.device}")
    n = keys.shape[0]
    if (keys.dtype != torch.int32 or keys.dim() != 1
            or not keys.is_contiguous() or n % BLOCK or n == 0
            or n >= 2 ** 31):
        raise ValueError(f"radix {what}: keys must be a contiguous int32 "
                         f"[n], n a positive multiple of {BLOCK}; got "
                         f"{keys.dtype} {list(keys.shape)}")


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
    _check_cuda_keys("rank_hist", keys)
    n = keys.shape[0]
    if shift not in (0, 8, 16, 24):
        raise ValueError(f"radix rank_hist: shift {shift} not in 0/8/16/24")
    rank = torch.empty(n, dtype=torch.int32, device=keys.device)
    hist = torch.empty((n // BLOCK, BINS), dtype=torch.int32,
                       device=keys.device)
    with torch.cuda.device(keys.device):
        _launch_rank_hist(_stream(keys.device), keys, rank, hist, shift)
    return rank, hist


# The launchers below take checked, allocated tensors and count what they
# launch; the public *_cuda wrappers check and allocate for one call, and
# one_pass on the card for one pass (or a whole sort, see there).

def _launch_rank_hist(stream, keys, rank, hist, shift) -> None:
    rc = _cuda.library().gpe_radix_rank_hist(
        keys.data_ptr(), rank.data_ptr(), hist.data_ptr(), hist.shape[0],
        shift, stream)
    _cuda.check(rc, "radix rank_hist")
    LAUNCHES["radix_rank_hist"] += 1


def _launch_offsets(stream, hist, part, offset) -> None:
    rc = _cuda.library().gpe_radix_offsets(
        hist.data_ptr(), part.data_ptr(), offset.data_ptr(), hist.shape[0],
        stream)
    _cuda.check(rc, "radix offsets")
    LAUNCHES["radix_offsets"] += 1


def _launch_scatter(stream, keys, payload, rank, hist, offset, out_keys,
                    out_payload, shift) -> None:
    rc = _cuda.library().gpe_radix_scatter(
        keys.data_ptr(), payload.data_ptr(), rank.data_ptr(),
        hist.data_ptr(), offset.data_ptr(), out_keys.data_ptr(),
        out_payload.data_ptr(), hist.shape[0], shift, stream)
    _cuda.check(rc, "radix scatter")
    LAUNCHES["radix_scatter"] += 1


def _check_vector(what: str, name: str, a: torch.Tensor, n: int,
                   device) -> None:
    if (a.dtype != torch.int32 or tuple(a.shape) != (n,)
            or not a.is_contiguous() or a.device != device):
        raise ValueError(f"radix {what}: {name} must be a contiguous int32 "
                         f"[{n}] on {device}; got {a.dtype} "
                         f"{list(a.shape)} on {a.device}")


def _check_rows(what: str, name: str, a: torch.Tensor, nblocks: int,
                device) -> None:
    if (a.dtype != torch.int32 or tuple(a.shape) != (nblocks, BINS)
            or not a.is_contiguous() or a.device != device):
        raise ValueError(f"radix {what}: {name} must be a contiguous int32 "
                         f"[{nblocks}, {BINS}] on {device}; got {a.dtype} "
                         f"{list(a.shape)} on {a.device}")


def digit_offsets(hist: torch.Tensor) -> torch.Tensor:
    """offset i32 [nblocks, BINS]: where block b's keys of digit d start in
    the pass's output, the exclusive scan of ``hist`` in (digit, block)
    order."""
    if hist.device.type == "cpu":
        return digit_offsets_plain(hist)
    return digit_offsets_cuda(hist)


def digit_offsets_plain(hist: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``radix_offsets`` (any device)."""
    flat = hist.t().reshape(-1).to(torch.int64)  # [digit, block]
    base = torch.cumsum(flat, 0) - flat
    return base.view(BINS, hist.shape[0]).t().contiguous().to(torch.int32)


def digit_offsets_cuda(hist: torch.Tensor) -> torch.Tensor:
    """Launch ``radix_offsets`` (three kernels) on the histogram's CUDA
    device (raises for other tensors)."""
    if hist.device.type != "cuda":
        raise RuntimeError("radix offsets: the CUDA kernel needs a CUDA "
                           f"tensor, got {hist.device}")
    nblocks = hist.shape[0]
    _check_rows("offsets", "hist", hist, nblocks, hist.device)
    if nblocks == 0 or nblocks * BLOCK >= 2 ** 31:
        raise ValueError(f"radix offsets: {nblocks} blocks out of range")
    part = torch.empty((-(-nblocks // OFFSET_ROWS), BINS),
                       dtype=torch.int32, device=hist.device)
    offset = torch.empty_like(hist)
    with torch.cuda.device(hist.device):
        _launch_offsets(_stream(hist.device), hist, part, offset)
    return offset


def scatter(keys: torch.Tensor, payload: torch.Tensor, rank: torch.Tensor,
            hist: torch.Tensor, offset: torch.Tensor, shift: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pass's output: key i and payload i at offset[i // BLOCK,
    digit(i)] + rank[i].  ``hist`` is the kernel's (it stages each block
    in digit order); the plain version does not need it."""
    if keys.device.type == "cpu":
        return scatter_plain(keys, payload, rank, offset, shift)
    return scatter_cuda(keys, payload, rank, hist, offset, shift)


def scatter_plain(keys: torch.Tensor, payload: torch.Tensor,
                  rank: torch.Tensor, offset: torch.Tensor, shift: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``radix_scatter`` (any device)."""
    n = keys.shape[0]
    block = torch.arange(n, device=keys.device) // BLOCK
    dest = offset[block, digits(keys, shift).to(torch.int64)].to(
        torch.int64) + rank
    out_keys, out_payload = torch.empty_like(keys), torch.empty_like(payload)
    out_keys[dest] = keys
    out_payload[dest] = payload
    return out_keys, out_payload


def scatter_cuda(keys: torch.Tensor, payload: torch.Tensor,
                 rank: torch.Tensor, hist: torch.Tensor,
                 offset: torch.Tensor, shift: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``radix_scatter`` on the keys' CUDA device (raises for other
    tensors, and for a payload that is not int32: nothing is converted)."""
    _check_cuda_keys("scatter", keys)
    n = keys.shape[0]
    _check_vector("scatter", "payload", payload, n, keys.device)
    _check_vector("scatter", "rank", rank, n, keys.device)
    _check_rows("scatter", "hist", hist, n // BLOCK, keys.device)
    _check_rows("scatter", "offset", offset, n // BLOCK, keys.device)
    if shift not in (0, 8, 16, 24):
        raise ValueError(f"radix scatter: shift {shift} not in 0/8/16/24")
    out_keys, out_payload = torch.empty_like(keys), torch.empty_like(payload)
    with torch.cuda.device(keys.device):
        _launch_scatter(_stream(keys.device), keys, payload, rank, hist,
                        offset, out_keys, out_payload, shift)
    return out_keys, out_payload


class PassWork(NamedTuple):
    """What a pass on the card writes besides its output: ranks i32 [n],
    histograms and offsets i32 [nblocks, BINS], and the offsets' chunk
    sums i32 [ceil(nblocks / OFFSET_ROWS), BINS]."""
    rank: torch.Tensor
    hist: torch.Tensor
    offset: torch.Tensor
    part: torch.Tensor


def pass_work(keys: torch.Tensor, payload: torch.Tensor) -> PassWork:
    """Check CUDA int32 keys and payload for a pass and allocate its
    work tensors (raises for other tensors, and for a payload that is not
    int32: nothing is converted)."""
    _check_cuda_keys("pass", keys)
    n, dev = keys.shape[0], keys.device
    _check_vector("pass", "payload", payload, n, dev)
    nblocks = n // BLOCK
    hist = torch.empty((nblocks, BINS), dtype=torch.int32, device=dev)
    return PassWork(
        torch.empty(n, dtype=torch.int32, device=dev), hist,
        torch.empty_like(hist),
        torch.empty((-(-nblocks // OFFSET_ROWS), BINS), dtype=torch.int32,
                    device=dev))


def one_pass(keys: torch.Tensor, payload: torch.Tensor, shift: int,
             work: Optional[PassWork] = None,
             out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stable pass on the digit at ``shift`` (int32 key bits): the
    plain versions on a CPU tensor, the three kernels on a CUDA one.  On
    the card ``work`` (from ``pass_work`` for these tensors' shapes) and
    ``out`` (key and payload buffers that alias neither input) may be
    given, already checked: a sort checks and allocates once, since its
    host time per pass would otherwise rival the kernels' device time."""
    if keys.device.type == "cpu":
        rank, hist = rank_hist_plain(keys, shift)
        return scatter_plain(keys, payload, rank, digit_offsets_plain(hist),
                             shift)
    if shift not in (0, 8, 16, 24):
        raise ValueError(f"radix pass: shift {shift} not in 0/8/16/24")
    if work is None:
        work = pass_work(keys, payload)
    if out is None:
        out = (torch.empty_like(keys), torch.empty_like(payload))
    with torch.cuda.device(keys.device):
        stream = _stream(keys.device)
        _launch_rank_hist(stream, keys, work.rank, work.hist, shift)
        _launch_offsets(stream, work.hist, work.part, work.offset)
        _launch_scatter(stream, keys, payload, work.rank, work.hist,
                        work.offset, out[0], out[1], shift)
    return out


def radix_sort_pairs(keys: torch.Tensor, payload: torch.Tensor,
                     num_bits: int = 32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort by the u32 ``keys`` (int64 tensor, values <
    2**num_bits) with one payload (int32 on a CUDA device).  Pads to a
    BLOCK multiple with 0xFFFFFFFF keys, which sort last.  Each pass is
    ``one_pass``; on a CUDA tensor the sort checks and allocates once and
    its passes ping-pong between two pairs of fresh buffers (the caller's
    tensors are only read)."""
    n = keys.shape[0]
    if n == 0:
        return keys, payload
    pad = -n % BLOCK
    bits = as_i32_bits(keys)
    if pad:
        bits = torch.cat([bits, bits.new_full((pad,), SENTINEL)])
        payload = torch.cat([payload, payload.new_zeros(pad)])
    work, bufs = None, [None, None]
    if keys.device.type == "cuda":
        work = pass_work(bits, payload)
        bufs = [(torch.empty_like(bits), torch.empty_like(payload))
                for _ in range(2)]
    for p in range((num_bits + 7) // 8):
        bits, payload = one_pass(bits, payload, 8 * p, work, bufs[p % 2])
    return from_i32_bits(bits[:n]), payload[:n]
