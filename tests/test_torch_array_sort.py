"""The port's radix sort (gpu_physics_engine_torch/ops/radix_sort.py,
ops/sort.py) against the JAX package's on the CPU.

The tile-local ranks of the pass's plain version (``rank_hist_plain`` at
``tile=1024``) are held to the JAX package's ``_rank_hist`` run in
interpret mode, on about 3 blocks with duplicates and 0xFFFFFFFF
sentinels, for all four digit shifts: ranks and histograms exact.  The
plain histogram, digit-offset scan, look-back and scatter are held to
numpy on the same keys; one pass (``onesweep_pass_plain``, what the CPU
runs)
to a stable numpy sort by the digit at ragged sizes around a tile, with
all-equal keys and all sentinels; four passes to
``torch.sort(stable=True)``.  The whole radix sort is held to the JAX one
and to ``torch.sort(stable=True)``.  The CUDA kernels are held to the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py); here
their wrappers refuse what the kernels do not take.
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
    tr, th = tradix.rank_hist_plain(bits, shift, tile=1024)
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
    """The pass's offsets, the digit bases (the scan of the sort's
    histogram row) plus each tile's exclusive prefix (``lookback_plain``
    less the tile's count), equal numpy's (digit, tile) scan."""
    keys = torch.from_numpy(_rank_keys().astype(np.int64))
    bits = tradix.as_i32_bits(keys)
    _, hist = tradix.rank_hist_plain(bits, shift)
    bases = tradix.digit_bases(tradix.digit_hist_plain(keys)[shift // 8])
    off = tradix.digit_offsets_plain(hist, bases)
    assert off.dtype == torch.int32 and off.shape == hist.shape
    np.testing.assert_array_equal(off.numpy(),
                                  _np_digit_offsets(hist.numpy()))


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
def test_plain_pass_is_a_stable_sort_by_the_digit(shift):
    """rank_hist_plain, digit_offsets_plain and scatter_plain composed at
    1024-key tiles equal a stable numpy sort of keys and payload by the
    digit at ``shift``, the scatter putting key i at offset[i // 1024,
    digit] + rank[i]; the pass the CPU runs (``onesweep_pass_plain``,
    4096-key tiles, int64 keys in and out) equals it too."""
    keys = _rank_keys(seed=shift)
    bits = tradix.as_i32_bits(torch.from_numpy(keys.astype(np.int64)))
    vals = torch.from_numpy(np.random.default_rng(shift).integers(
        -2 ** 31, 2 ** 31, len(keys), dtype=np.int64).astype(np.int32))
    rank, hist = tradix.rank_hist_plain(bits, shift)
    bases = tradix.digit_bases(hist.sum(0))
    off = tradix.digit_offsets_plain(hist, bases)
    sk, sv = tradix.scatter_plain(bits, vals, rank, off, shift)
    digit = (keys >> shift) & 255
    dest = off.numpy()[np.arange(len(keys)) // tradix.BLOCK, digit] \
        + rank.numpy()
    np.testing.assert_array_equal(np.sort(dest), np.arange(len(keys)))
    np.testing.assert_array_equal(sk.numpy()[dest], bits.numpy())
    order = np.argsort(digit, kind="stable")
    np.testing.assert_array_equal(sk.numpy(), bits.numpy()[order])
    np.testing.assert_array_equal(sv.numpy(), vals.numpy()[order])
    wide = torch.from_numpy(keys.astype(np.int64))
    pk, pv = tradix.onesweep_pass_plain(wide, vals, shift, bases)
    assert pk.dtype == torch.int64
    assert torch.equal(pk, tradix.from_i32_bits(sk)) and torch.equal(pv, sv)


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


T = tradix.TILE


def _kind_keys(kind: str, n: int, seed: int) -> np.ndarray:
    if kind == "equal":
        return np.full(n, 0x01020304, np.int64)
    if kind == "sentinel":
        return np.full(n, 0xFFFFFFFF, np.int64)
    return _rank_keys(seed=seed, n=n).astype(np.int64)


@pytest.mark.parametrize("kind", ["mixed", "equal", "sentinel"])
def test_digit_hist_plain_matches_bincount(kind):
    keys = _kind_keys(kind, 3 * T + 17, seed=5)
    hist = tradix.digit_hist_plain(torch.from_numpy(keys))
    assert hist.dtype == torch.int32 and hist.shape == (4, 256)
    for p in range(4):
        np.testing.assert_array_equal(
            hist[p].numpy(), np.bincount((keys >> 8 * p) & 255,
                                         minlength=256))


@pytest.mark.parametrize("n", [1, T - 1, T, T + 1, 3 * T + 17])
@pytest.mark.parametrize("kind", ["mixed", "equal", "sentinel"])
def test_onesweep_pass_plain_is_a_stable_partition(n, kind):
    """Each pass, on the keys the earlier passes leave, is a stable
    partition by its digit (numpy's stable argsort), int64 keys in on the
    first pass and out on the last; the four compose to torch.sort."""
    keys = torch.from_numpy(_kind_keys(kind, n, seed=n))
    vals = torch.arange(n, dtype=torch.int32)
    hist = tradix.digit_hist_plain(keys)
    cur, cv = keys, vals
    for p in range(4):
        od = torch.int64 if p == 3 else torch.int32
        ok, ov = tradix.onesweep_pass_plain(
            cur, cv, 8 * p, tradix.digit_bases(hist[p]), out_dtype=od)
        assert ok.dtype == od and ov.dtype == torch.int32
        u = cur.numpy().astype(np.int64) & 0xFFFFFFFF
        order = np.argsort((u >> 8 * p) & 255, kind="stable")
        np.testing.assert_array_equal(ok.numpy().astype(np.int64)
                                      & 0xFFFFFFFF, u[order])
        np.testing.assert_array_equal(ov.numpy(), cv.numpy()[order])
        cur, cv = ok, ov
    wk, wi = torch.sort(keys, stable=True)
    assert torch.equal(cur, wk) and torch.equal(cv, wi.to(torch.int32))


def test_lookback_plain_equals_cumsum_over_tiles():
    bits = tradix.as_i32_bits(torch.from_numpy(
        _rank_keys(seed=9, n=5 * T + 3).astype(np.int64)))
    _, hist = tradix.rank_hist_plain(bits, 8, tile=T)
    assert hist.shape == (6, 256)
    got = tradix.lookback_plain(hist)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.cumsum(hist.numpy(), 0))


def _refusals(case):
    """(callable, exception, message) triples of one refusal case."""
    i32 = dict(dtype=torch.int32)
    i64 = dict(dtype=torch.int64)
    hist = torch.zeros((4, 256), **i32)
    keys, vals = torch.zeros(T, **i64), torch.zeros(T, **i32)
    meta = torch.zeros(T, device="meta", **i64)
    meta_vals = torch.zeros(T, device="meta", **i32)
    big = torch.empty(2 ** 31, device="meta", **i64)
    return {
        "cpu": [(lambda: tradix.digit_hist_cuda(keys), RuntimeError, "CUDA"),
                (lambda: tradix.onesweep_pass_cuda(keys, vals, 0, hist),
                 RuntimeError, "CUDA")],
        "meta": [(lambda: tradix.digit_hist_cuda(meta), RuntimeError,
                  "CUDA"),
                 (lambda: tradix.onesweep_pass_cuda(meta, meta_vals, 0,
                                                    hist.to("meta")),
                  RuntimeError, "CUDA"),
                 (lambda: tradix.radix_sort_pairs(meta, meta_vals),
                  RuntimeError, "CUDA")],
        "dtype": [(lambda: tradix.digit_hist_cuda(vals), ValueError,
                   "keys"),
                  (lambda: tradix.onesweep_pass_cuda(keys.float(), vals, 0,
                                                     hist),
                   ValueError, "keys"),
                  (lambda: tradix.onesweep_pass_cuda(keys, keys, 0, hist),
                   ValueError, "payload"),
                  (lambda: tradix.onesweep_pass_cuda(keys, vals, 0,
                                                     hist.long()),
                   ValueError, "hist")],
        "oversized": [(lambda: tradix.digit_hist_cuda(big), ValueError,
                       "2\\*\\*31"),
                      (lambda: tradix.radix_sort_pairs(
                          big, torch.empty(2 ** 31, device="meta", **i32)),
                       ValueError, "2\\*\\*31")],
        "empty": [(lambda: tradix.digit_hist_cuda(keys[:0]), ValueError,
                   "keys"),
                  (lambda: tradix.onesweep_pass_cuda(keys[:0], vals[:0], 0,
                                                     hist),
                   ValueError, "keys")],
        "shift": [(lambda: tradix.onesweep_pass_cuda(keys, vals, 4, hist),
                   ValueError, "shift")],
    }[case]


@pytest.mark.parametrize("case", ["cpu", "meta", "dtype", "oversized",
                                  "empty", "shift"])
def test_radix_cuda_wrappers_refuse(case):
    """The kernels' wrappers refuse a tensor off the card (no fallback to
    the plain version), keys or a payload of another type, no keys, 2**31
    keys or more, and a shift that is no digit's."""
    for fn, exc, msg in _refusals(case):
        with pytest.raises(exc, match=msg):
            fn()
