"""Stable LSD radix sort of u32 keys with one payload
(``gpu_physics_engine_tpu.ops.radix_sort``): one digit histogram a sort,
then one hand kernel a pass.

A sort of n keys (u32 values in int64) on the card:
  1. the histogram: one read of the keys gives the 256-bin histogram of
     each of the four 8-bit digits, hist[pass, digit] (a histogram does
     not depend on key order, so it serves every pass); the exclusive scan
     of a pass's row is its digit bases, where each digit's keys start in
     the pass's output (``digit_bases``);
  2. per pass (digit at shift 8p), the onesweep pass: per tile of TILE
     keys, each key's stable rank among the tile's keys with its digit and
     the tile's count of each digit; the exclusive prefix of those counts
     over the earlier tiles (a decoupled look-back on the card,
     ``lookback_plain`` gives its inclusive form); key and payload go to
     bases[digit] + that prefix + the rank, a permutation of [0, n).
Stability across passes gives ascending original index among equal keys,
the order ``torch.sort(stable=True)`` gives.  The first pass reads the
caller's int64 keys and the last writes int64 keys; between passes keys
travel as the int32 view of their u32 bits.  A ragged last tile needs no
padding.

The pass replaces K12, ``_rank_hist`` (gpu_physics_engine_tpu/
ops/radix_sort.py:80, kernel ``_rank_hist_kernel`` :51), and the XLA
steps of that module's ``_one_pass`` (:103-127: the cumsum, the scatter of
the inverse permutation and its gathers); the histogram replaces the
digit-major half of that cumsum.  Both are CUDA C++ in
csrc/radix_kernels.cuh (bounds and designs there).  ``radix_sort_pairs``
launches them for a CUDA tensor and runs their plain versions
(``digit_hist_plain``; ``onesweep_pass_plain``: ``rank_hist_plain``,
``digit_offsets_plain`` with ``lookback_plain``, ``scatter_plain``) for a
CPU tensor; anything else raises, and there is no fallback from a CUDA
tensor.  ``digit_hist_cuda`` and ``onesweep_pass_cuda`` launch one kernel
each (the checks against the plain versions use them).  Each launch adds
one to its ``LAUNCHES`` entry.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gpu_physics_engine_torch.ops import _cuda
from gpu_physics_engine_torch.ops.tiled_kernels import _stream

BLOCK = 1024  # the JAX kernel's key block: rank_hist_plain's default tile
TILE = 4096  # keys a CTA of radix_onesweep_kernel (kSweepTile)
BINS = 256
PASSES = 4
# the scratch's look-back array starts after hist i32[4][256] and eight
# i32 tile counters (kLookOffset), in int64 words
LOOK_OFFSET = (PASSES * BINS + 8) * 4 // 8

LAUNCHES = {"radix_digit_hist": 0, "radix_onesweep": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def as_i32_bits(keys: torch.Tensor) -> torch.Tensor:
    """int32 tensor with the bits of the u32 values held in ``keys``
    (int64, 0 .. 0xFFFFFFFF): the conversion keeps the low 32 bits."""
    return keys.to(torch.int32)


def from_i32_bits(bits: torch.Tensor) -> torch.Tensor:
    """The u32 values (int64) of an int32 bit view."""
    return bits.to(torch.int64) & 0xFFFFFFFF


def digits(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """(key >> shift) & 255 of the u32 keys (int64 values, or the int32
    bits: the arithmetic shift fills bits that the mask drops)."""
    return (keys >> shift) & (BINS - 1)


def num_tiles(n: int) -> int:
    return -(-n // TILE)


def scratch_words(ntiles: int) -> int:
    """int64 words of a sort's scratch (``gpe_radix_scratch_bytes`` / 8):
    the histogram, the tile counters and the look-back array
    u64[ntiles, BINS]."""
    return LOOK_OFFSET + ntiles * BINS


def _scratch_hist(scratch: torch.Tensor) -> torch.Tensor:
    return scratch[:PASSES * BINS // 2].view(torch.int32).view(PASSES, BINS)


# ---------------------------------------------------------------------------
# plain versions (any device; the CPU path runs them)
# ---------------------------------------------------------------------------

def digit_hist_plain(keys: torch.Tensor) -> torch.Tensor:
    """hist i32 [PASSES, BINS]: the count of each value of each 8-bit
    digit of the u32 ``keys``."""
    return torch.stack([torch.bincount(digits(keys, 8 * p).to(torch.int64),
                                       minlength=BINS)
                        for p in range(PASSES)]).to(torch.int32)


def digit_bases(row: torch.Tensor) -> torch.Tensor:
    """The exclusive scan of one pass's histogram row: where each digit's
    keys start in the pass's output."""
    row = row.to(torch.int64)
    return (torch.cumsum(row, 0) - row).to(torch.int32)


def rank_hist_plain(keys: torch.Tensor, shift: int, tile: int = BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable in-tile digit ranks i32 [n] and tile histograms i32
    [ceil(n / tile), BINS] of ``keys`` (the last tile may be ragged).  At
    ``tile=BLOCK`` this is the JAX kernel's function.  A stable sort of
    tile * 256 + digit; a key's rank is its place in its group."""
    n = keys.shape[0]
    ntiles = -(-n // tile)
    tid = torch.arange(n, device=keys.device) // tile
    group = tid * BINS + digits(keys, shift).to(torch.int64)
    hist = torch.bincount(group, minlength=ntiles * BINS)
    start = torch.cumsum(hist, 0) - hist
    order = torch.sort(group, stable=True)[1]
    rank = torch.empty(n, dtype=torch.int64, device=keys.device)
    rank[order] = torch.arange(n, device=keys.device) - start[group[order]]
    return rank.to(torch.int32), hist.view(ntiles, BINS).to(torch.int32)


def lookback_plain(hist: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix over tiles of each digit's count, i32
    [ntiles, BINS]: what the look-back array holds at the end of a pass
    (in the low half of each word)."""
    return torch.cumsum(hist.to(torch.int64), 0).to(torch.int32)


def digit_offsets_plain(hist: torch.Tensor, bases: torch.Tensor
                        ) -> torch.Tensor:
    """offset i32 [ntiles, BINS]: where tile t's keys of digit d start in
    the pass's output, the digit's base plus the tile's exclusive prefix
    of the digit (the look-back's sum).  With the bases of the tiles' own
    counts this is the exclusive scan of ``hist`` in (digit, tile)
    order."""
    return bases.to(torch.int32)[None, :] + lookback_plain(hist) - hist


def scatter_plain(keys: torch.Tensor, payload: torch.Tensor,
                  rank: torch.Tensor, offset: torch.Tensor, shift: int,
                  tile: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key i and payload i to offset[i // tile, digit(i)] + rank[i]."""
    n = keys.shape[0]
    tid = torch.arange(n, device=keys.device) // tile
    dest = offset[tid, digits(keys, shift).to(torch.int64)].to(
        torch.int64) + rank
    out_keys, out_payload = torch.empty_like(keys), torch.empty_like(payload)
    out_keys[dest] = keys
    out_payload[dest] = payload
    return out_keys, out_payload


def onesweep_pass_plain(keys: torch.Tensor, payload: torch.Tensor,
                        shift: int, bases: torch.Tensor, tile: int = TILE,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``radix_onesweep_kernel`` (any device),
    tile by tile: the tile-local stable ranks and digit counts, their
    exclusive prefix over tiles (the look-back), and the store at
    bases[digit] + prefix + rank.  ``keys`` are int64 u32 values or int32
    bits; the output keys are ``out_dtype`` (default: the input's)."""
    bits = as_i32_bits(keys) if keys.dtype == torch.int64 else keys
    rank, hist = rank_hist_plain(bits, shift, tile)
    out, out_payload = scatter_plain(bits, payload, rank,
                                     digit_offsets_plain(hist, bases),
                                     shift, tile)
    if (out_dtype or keys.dtype) == torch.int64:
        out = from_i32_bits(out)
    return out, out_payload


# ---------------------------------------------------------------------------
# the card: checks, launchers, wrappers
# ---------------------------------------------------------------------------

def _check_keys(what: str, keys: torch.Tensor, dtypes) -> None:
    n = keys.shape[0] if keys.dim() == 1 else 0
    if (keys.dtype not in dtypes or keys.dim() != 1
            or not keys.is_contiguous() or not 0 < n < 2 ** 31):
        raise ValueError(f"radix {what}: keys must be a contiguous "
                         f"{' or '.join(map(str, dtypes))} [n], 0 < n < "
                         f"2**31; got {keys.dtype} {list(keys.shape)}")


def _check_device(what: str, keys: torch.Tensor) -> None:
    if keys.device.type != "cuda":
        raise RuntimeError(f"radix {what}: the CUDA kernel needs a CUDA "
                           f"tensor, got {keys.device}")


def _check_payload(what: str, payload: torch.Tensor, keys: torch.Tensor
                   ) -> None:
    n = keys.shape[0]
    if (payload.dtype != torch.int32 or tuple(payload.shape) != (n,)
            or not payload.is_contiguous() or payload.device != keys.device):
        raise ValueError(f"radix {what}: payload must be a contiguous int32 "
                         f"[{n}] on {keys.device}; got {payload.dtype} "
                         f"{list(payload.shape)} on {payload.device}")


def _launch_hist(stream, keys, scratch, ntiles) -> None:
    rc = _cuda.library().gpe_radix_digit_hist(
        keys.data_ptr(), scratch.data_ptr(), keys.shape[0], ntiles, stream)
    _cuda.check(rc, "radix digit_hist")
    LAUNCHES["radix_digit_hist"] += 1


def _launch_onesweep(stream, keys, payload, out_keys, out_payload, scratch,
                     shift) -> None:
    rc = _cuda.library().gpe_radix_onesweep(
        keys.data_ptr(), payload.data_ptr(), out_keys.data_ptr(),
        out_payload.data_ptr(), scratch.data_ptr(), keys.shape[0], shift,
        int(keys.dtype == torch.int64), int(out_keys.dtype == torch.int64),
        stream)
    _cuda.check(rc, "radix onesweep")
    LAUNCHES["radix_onesweep"] += 1


def digit_hist_cuda(keys: torch.Tensor) -> torch.Tensor:
    """Launch ``radix_digit_hist_kernel`` on the keys' CUDA device (raises
    for other tensors)."""
    _check_keys("digit_hist", keys, (torch.int64,))
    _check_device("digit_hist", keys)
    scratch = torch.empty(scratch_words(0), dtype=torch.int64,
                          device=keys.device)
    with torch.cuda.device(keys.device):
        _launch_hist(_stream(keys.device), keys, scratch, 0)
    return _scratch_hist(scratch)


def onesweep_pass_cuda(keys: torch.Tensor, payload: torch.Tensor,
                       shift: int, hist: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``radix_onesweep_kernel`` for one pass, given the sort's
    digit histogram ``hist`` [PASSES, BINS], with a look-back state of its
    own (raises for other tensors; a payload that is not int32 is
    refused, not converted).  Returns the output keys and payload and the
    look-back array u64 [ntiles, BINS] as int64: each word the tile's
    inclusive prefix of the digit (low half) and the flag pass * 4 + 2
    (high half)."""
    _check_keys("onesweep", keys, (torch.int32, torch.int64))
    _check_payload("onesweep", payload, keys)
    if shift not in (0, 8, 16, 24):
        raise ValueError(f"radix onesweep: shift {shift} not in 0/8/16/24")
    out_dtype = out_dtype or keys.dtype
    if out_dtype not in (torch.int32, torch.int64):
        raise ValueError(f"radix onesweep: out_dtype {out_dtype}")
    if (hist.dtype != torch.int32 or tuple(hist.shape) != (PASSES, BINS)
            or hist.device != keys.device):
        raise ValueError(f"radix onesweep: hist must be int32 "
                         f"[{PASSES}, {BINS}] on {keys.device}; got "
                         f"{hist.dtype} {list(hist.shape)} on {hist.device}")
    _check_device("onesweep", keys)
    n, dev = keys.shape[0], keys.device
    ntiles = num_tiles(n)
    scratch = torch.zeros(scratch_words(ntiles), dtype=torch.int64,
                          device=dev)
    _scratch_hist(scratch).copy_(hist)
    out = torch.empty(n, dtype=out_dtype, device=dev)
    out_payload = torch.empty_like(payload)
    with torch.cuda.device(dev):
        _launch_onesweep(_stream(dev), keys, payload, out, out_payload,
                         scratch, shift)
    return out, out_payload, scratch[LOOK_OFFSET:].view(ntiles, BINS)


def radix_sort_pairs(keys: torch.Tensor, payload: torch.Tensor,
                     num_bits: int = 32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort by the u32 ``keys`` (int64 tensor, values <
    2**num_bits) with one payload (int32 on a CUDA device).  On a CUDA
    tensor: one ``radix_digit_hist_kernel`` launch (after zeroing the
    sort's scratch), then one ``radix_onesweep_kernel`` launch a pass,
    ping-ponging between fresh buffers (the caller's tensors are only
    read)."""
    n = keys.shape[0]
    if n == 0:
        return keys, payload
    npass = (num_bits + 7) // 8
    if not 1 <= npass <= PASSES:
        raise ValueError(f"radix sort: num_bits {num_bits} not in 1..32")
    if keys.device.type == "cpu":
        hist = digit_hist_plain(keys)
        for p in range(npass):
            keys, payload = onesweep_pass_plain(
                keys, payload, 8 * p, digit_bases(hist[p]),
                out_dtype=torch.int64 if p == npass - 1 else torch.int32)
        return keys, payload
    _check_keys("sort", keys, (torch.int64,))
    _check_payload("sort", payload, keys)
    _check_device("sort", keys)
    dev = keys.device
    ntiles = num_tiles(n)
    scratch = torch.empty(scratch_words(ntiles), dtype=torch.int64,
                          device=dev)
    bufs = [(torch.empty(n, dtype=torch.int32, device=dev),
             torch.empty_like(payload)) for _ in range(min(npass - 1, 2))]
    with torch.cuda.device(dev):
        stream = _stream(dev)
        _launch_hist(stream, keys, scratch, ntiles)
        for p in range(npass):
            out = (bufs[p % 2] if p < npass - 1 else
                   (torch.empty(n, dtype=torch.int64, device=dev),
                    torch.empty_like(payload)))
            _launch_onesweep(stream, keys, payload, *out, scratch, 8 * p)
            keys, payload = out
    return keys, payload
