"""The port's sort + shift Jacobi solve (gpu_physics_engine_torch/ops/
fast_solve.py, SimConfig.solver="fast") against the JAX package's
ops/fast_solve.py on the same numpy-seeded inputs.

The candidate entries and the overflow count must match exactly.  The
solved positions: within 1e-5 world units with fast_pack_bf16 off, and
within one bf16 ulp of each particle's correction plus 1e-6 with it on.
JAX sorts unstably and the port stably, so equal cell ids may meet in
another order, which changes the f32 rounding of the window sums (and,
past K occupants, which pairs a run finds: the position comparisons use
scenes without overflow).  Measured on this file's scenes: no difference
at all, packing on or off.  The JAX package's golden tests of the solve
are mirrored on the port.  One JAX compile per configuration, shared by
the module.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu import SimConfig as JConfig
from gpu_physics_engine_tpu.ops import fast_solve as jfs
from gpu_physics_engine_torch import SimConfig as TConfig
from gpu_physics_engine_torch.ops import fast_solve as tfs
from test_fast_solve import CELL, _jacobi_golden


def _kw(n, K, **kw):
    return dict(max_particles=n, initial_particles=n, world_width=64.0,
                world_height=64.0, initial_radius=1.0, max_occupancy=K,
                **kw)


def _padded(positions, radii, cap):
    """(x, y, r, active) numpy planes of length ``cap``."""
    positions = np.asarray(positions, np.float32).reshape(-1, 2)
    n = len(positions)
    x, y, r = (np.zeros(cap, np.float32) for _ in range(3))
    x[:n], y[:n], r[:n] = positions[:, 0], positions[:, 1], radii
    return x, y, r, np.arange(cap) < n


def _port(planes, cell, cfg):
    x, y, r, act = (torch.from_numpy(np.array(a)) for a in planes)
    nx, ny, ovf = tfs.solve_fast(x, y, r, act,
                                 torch.tensor(cell, dtype=torch.float32),
                                 cfg)
    return nx.numpy(), ny.numpy(), int(ovf)


@functools.lru_cache(maxsize=None)
def _jax_solve(n: int, K: int, pack: bool):
    cfg = JConfig(**_kw(n, K, fast_pack_bf16=pack))
    return jax.jit(lambda x, y, r, a, c: jfs.solve_fast(x, y, r, a, c, cfg))


def _scene(n, seed, lo=3.0, hi=60.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    rad = rng.uniform(0.6, 1.0, n).astype(np.float32)
    return pos, rad


def test_candidate_entries_equal_jax():
    pos, rad = _scene(250, 1)
    planes = _padded(pos, rad, 1024)
    want = jax.jit(jfs.build_candidate_entries)(*planes, np.float32(CELL))
    got = tfs.build_candidate_entries(
        *(torch.from_numpy(np.array(a)) for a in planes),
        torch.tensor(CELL, dtype=torch.float32))
    names = ("cells", "idx", "x", "y", "r")
    for name, w, g in zip(names, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            g.numpy().dtype), err_msg=name)
    cells = got[0].numpy().reshape(4, -1)
    # every live particle has its home slot and at least one neighbour
    assert (cells[0, :250] != 0xFFFFFFFF).all()
    assert (cells[1:, :250] != 0xFFFFFFFF).any(axis=0).mean() > 0.5
    assert (cells[:, 250:] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("pack", [False, True], ids=["f32", "bf16"])
def test_solve_fast_matches_jax(pack):
    n = 300
    pos, rad = _scene(n, 2)
    cfg = TConfig(**_kw(n, 8, fast_pack_bf16=pack))
    planes = _padded(pos, rad, cfg.capacity)
    jx, jy, jo = _jax_solve(n, 8, pack)(*planes, np.float32(CELL))
    jx, jy = np.asarray(jx), np.asarray(jy)
    tx, ty, to = _port(planes, CELL, cfg)
    assert to == int(jo) == 0
    assert (jx[:n] != pos[:, 0]).sum() > 50  # the scene has contacts
    for got, want, start in ((tx, jx, planes[0]), (ty, jy, planes[1])):
        if pack:
            # one bf16 ulp of the correction (8 significant bits)
            ulp = np.abs(want - start) * 2.0 ** -7
            assert (np.abs(got - want) <= ulp + 1e-6).all()
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_overflow_count_equals_jax():
    """A jam past K: the overflow count is the same whatever the order of
    equal cell ids (each run longer than K counts its surplus)."""
    n = 200
    pos, rad = _scene(n, 3, lo=20.0, hi=30.0)
    cfg = TConfig(**_kw(n, 4))
    planes = _padded(pos, rad, cfg.capacity)
    _, _, jo = _jax_solve(n, 4, True)(*planes, np.float32(CELL))
    _, _, to = _port(planes, CELL, cfg)
    assert to == int(jo) > 0


def test_solve_is_deterministic_and_keeps_inactive_slots():
    pos, rad = _scene(300, 4, lo=10.0, hi=30.0)
    cfg = TConfig(**_kw(300, 4))
    planes = _padded(pos, rad, cfg.capacity)
    a, b = _port(planes, CELL, cfg), _port(planes, CELL, cfg)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    assert (a[0][300:] == 0).all() and (a[1][300:] == 0).all()


# the JAX package's golden tests (tests/test_fast_solve.py), on the port

def _solve(positions, radii, K=8):
    n = len(radii)
    cfg = TConfig(**_kw(n, K, fast_pack_bf16=False))
    x, y, ovf = _port(_padded(positions, radii, cfg.capacity), CELL, cfg)
    return np.stack([x[:n], y[:n]], -1), ovf


def test_single_pair_matches_colored_semantics():
    positions = [[CELL / 2 - 0.4, CELL / 2], [CELL / 2 + 0.4, CELL / 2]]
    got, ovf = _solve(positions, [0.5, 0.5])
    assert ovf == 0
    np.testing.assert_allclose(got[0], [CELL / 2 - 0.46, CELL / 2],
                               rtol=1e-6)
    np.testing.assert_allclose(got[1], [CELL / 2 + 0.46, CELL / 2],
                               rtol=1e-6)


def test_matches_jacobi_golden_model():
    rng = np.random.default_rng(10)
    n = 70
    positions = rng.uniform(3.0, 60.0, size=(n, 2)).astype(np.float32)
    radii = rng.uniform(0.6, 1.0, size=n).astype(np.float32)
    got, ovf = _solve(positions, radii, K=16)
    assert ovf == 0
    np.testing.assert_allclose(got, _jacobi_golden(positions, radii, CELL),
                               atol=2e-5)


def test_overflow_counted_for_long_runs():
    n = 20
    _, ovf = _solve([[3.0, 3.0]] * n, [1.0] * n, K=8)
    assert ovf > 0
