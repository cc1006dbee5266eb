"""The port's radix sort (gpu_physics_engine_torch/ops/radix_sort.py,
ops/sort.py) against the JAX package's on the CPU.

K12's plain version (``rank_hist_plain``, which the wrapper runs for a
CPU tensor) is held to the JAX package's ``_rank_hist`` run in interpret
mode, on about 3 blocks with duplicates and 0xFFFFFFFF sentinels, for all
four digit shifts: ranks and histograms exact.  The plain digit-offset scan
and scatter (the plain versions of ``radix_offsets`` and
``radix_scatter``) are held to numpy on the same keys, one pass of the
three to a stable numpy sort by the digit, and four passes to
``torch.sort(stable=True)``.  The whole radix sort is held to the JAX one
and to ``torch.sort(stable=True)``.  The CUDA kernels are held to the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu.ops import radix_sort as jradix
from gpu_physics_engine_torch.core.config import UNUSED_CELL_ID
from gpu_physics_engine_torch.ops import radix_sort as tradix
from gpu_physics_engine_torch.ops import sort as tsort


def u32(a) -> np.ndarray:
    """u32 values as int64, from either package."""
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


def _rank_keys(seed=3, n=3 * 1024):
    """About 3 blocks of u32 keys: duplicates (a few distinct digits per
    pass), full-range values and 0xFFFFFFFF sentinels."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.array([0, 1, 0x0101, 0xFF00FF, 0xDEADBEEF,
                                0x80000001], np.uint32), n)
    wide = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    keys = np.where(rng.random(n) < 0.4, wide, keys).astype(np.uint32)
    keys[rng.random(n) < 0.1] = 0xFFFFFFFF
    return keys


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
def test_rank_hist_plain_matches_jax_kernel(shift):
    keys = _rank_keys()
    jr, jh = jradix._rank_hist(jnp.asarray(keys), shift)
    bits = tradix.as_i32_bits(torch.from_numpy(keys.astype(np.int64)))
    assert bits.dtype == torch.int32
    tr, th = tradix.rank_hist(bits, shift)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert th.shape == (3, 256) and int(th.sum()) == len(keys)


def test_radix_sort_pairs_matches_jax_and_torch_sort():
    keys = _rank_keys()[:3000]  # padded to the same 3 blocks
    vals = np.arange(3000, dtype=np.int32)
    jk, jv = jradix.radix_sort_pairs(jnp.asarray(keys), jnp.asarray(vals))
    tk, tv = tradix.radix_sort_pairs(torch.from_numpy(keys.astype(np.int64)),
                                     torch.from_numpy(vals))
    np.testing.assert_array_equal(tk.numpy(), u32(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    sk, idx = torch.sort(torch.from_numpy(keys.astype(np.int64)), stable=True)
    assert torch.equal(tk, sk) and torch.equal(tv, idx.to(torch.int32))


def test_radix_sort_reverse_ramp_and_sentinels():
    n = 25_006  # the reference's off-block size
    keys = torch.arange(n - 1, -1, -1, dtype=torch.int64)
    sk, sv = tsort.sort_pairs(keys, torch.arange(n, dtype=torch.int32),
                              impl="radix")
    assert torch.equal(sk, torch.arange(n))
    assert torch.equal(sv, torch.arange(n - 1, -1, -1, dtype=torch.int32))
    keys = torch.tensor([7, UNUSED_CELL_ID, 3, UNUSED_CELL_ID, 0])
    sk, perm = tsort.argsort_u32(keys, impl="radix")
    assert sk.tolist() == [0, 3, 7, UNUSED_CELL_ID, UNUSED_CELL_ID]
    assert perm.tolist() == [4, 2, 0, 1, 3]  # stable
    assert tsort.argsort_u32(keys)[1].tolist() == perm.tolist()


def test_rank_hist_cuda_refuses_cpu_tensors():
    with pytest.raises(RuntimeError, match="CUDA"):
        tradix.rank_hist_cuda(torch.zeros(1024, dtype=torch.int32), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tradix.rank_hist(torch.zeros(1024, dtype=torch.int32,
                                     device="meta"), 0)


def _np_digit_offsets(hist: np.ndarray) -> np.ndarray:
    """offset[b, d]: keys of all smaller digits, then digit d's keys of
    earlier blocks (the (digit, block) exclusive scan)."""
    off = np.zeros_like(hist)
    run = 0
    for d in range(hist.shape[1]):
        for b in range(hist.shape[0]):
            off[b, d] = run
            run += hist[b, d]
    return off


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
def test_digit_offsets_plain_matches_numpy(shift):
    bits = tradix.as_i32_bits(torch.from_numpy(_rank_keys().astype(np.int64)))
    _, hist = tradix.rank_hist(bits, shift)
    off = tradix.digit_offsets(hist)
    assert off.dtype == torch.int32 and off.shape == hist.shape
    np.testing.assert_array_equal(off.numpy(),
                                  _np_digit_offsets(hist.numpy()))


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
def test_plain_pass_is_a_stable_sort_by_the_digit(shift):
    """rank_hist, digit_offsets and scatter composed (``one_pass``) equal a
    stable numpy sort of keys and payload by the digit at ``shift``, and
    the scatter puts key i at offset[i // BLOCK, digit] + rank[i]."""
    keys = _rank_keys(seed=shift)
    bits = tradix.as_i32_bits(torch.from_numpy(keys.astype(np.int64)))
    vals = torch.from_numpy(np.random.default_rng(shift).integers(
        -2 ** 31, 2 ** 31, len(keys), dtype=np.int64).astype(np.int32))
    rank, hist = tradix.rank_hist(bits, shift)
    off = tradix.digit_offsets(hist)
    sk, sv = tradix.scatter(bits, vals, rank, hist, off, shift)
    digit = (keys >> shift) & 255
    dest = off.numpy()[np.arange(len(keys)) // tradix.BLOCK, digit] \
        + rank.numpy()
    np.testing.assert_array_equal(np.sort(dest), np.arange(len(keys)))
    np.testing.assert_array_equal(sk.numpy()[dest], bits.numpy())
    order = np.argsort(digit, kind="stable")
    np.testing.assert_array_equal(sk.numpy(), bits.numpy()[order])
    np.testing.assert_array_equal(sv.numpy(), vals.numpy()[order])
    pk, pv = tradix.one_pass(bits, vals, shift)
    assert torch.equal(pk, sk) and torch.equal(pv, sv)


@pytest.mark.parametrize("n", [1024, 3000, 5 * 1024 + 1])
def test_plain_passes_compose_to_torch_sort(n):
    """Four plain passes over keys with duplicates and 0xFFFFFFFF
    sentinels equal torch.sort(stable=True), the payload its permutation."""
    keys = torch.from_numpy(_rank_keys(seed=n, n=n).astype(np.int64))
    sk, sv = tradix.radix_sort_pairs(keys, torch.arange(n, dtype=torch.int32))
    wk, wi = torch.sort(keys, stable=True)
    assert torch.equal(sk, wk) and torch.equal(sv, wi.to(torch.int32))


def test_i32_bits_round_trip():
    u = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF],
                 np.uint32)
    bits = tradix.as_i32_bits(torch.from_numpy(u.astype(np.int64)))
    np.testing.assert_array_equal(bits.numpy(), u.view(np.int32))
    back = tradix.from_i32_bits(bits)
    assert back.dtype == torch.int64
    np.testing.assert_array_equal(back.numpy(), u.astype(np.int64))


def test_radix_pass_cuda_wrappers_refuse_other_tensors():
    hist = torch.zeros((1, 256), dtype=torch.int32)
    keys = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tradix.digit_offsets_cuda(hist)
    with pytest.raises(RuntimeError, match="CUDA"):
        tradix.scatter_cuda(keys, keys, keys, hist, hist, 0)
    meta = dict(device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        tradix.digit_offsets(torch.zeros((1, 256), dtype=torch.int32, **meta))
    with pytest.raises(RuntimeError, match="CUDA"):
        tradix.scatter(torch.zeros(1024, dtype=torch.int32, **meta), keys,
                       keys, hist, hist, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tradix.pass_work(keys, keys)
    with pytest.raises(RuntimeError, match="CUDA"):
        tradix.one_pass(torch.zeros(1024, dtype=torch.int32, **meta),
                        torch.zeros(1024, dtype=torch.int32, **meta), 0)
