"""K4, the pull relocate in one launch (``tiled_kernels.relocate_one``), and
the tile division that it and the claim relocate share (``tiled._tile_of``).

On the CPU the wrapper runs its plain version, which is held bit for bit
against the JAX package's ``relocate_pallas_one`` in interpret mode (one
compile for the file, about 14 s here at cap 3) and against K2's plain
version under flip matching without hysteresis.  K4 finds the home tile
by a division and K2 by products, so the two part for a particle within an
ulp of a tile edge; the last test pins one such particle.  The CUDA kernel
is held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_tpu.ops.tiled_pallas import relocate_pallas_one
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.ops import tiled_kernels as tk
from test_torch_tiled import (FIELDS, assert_same, both_states, cfgs, scene,
                              teleport)


def _k4_scene():
    """tests/test_tiled.py's single-kernel scene at cap 3 in a 32 x 32
    world: 200 particles, displaced by up to 1.2 world units (about one
    tile), so that movers, pulls and deferrals all occur."""
    jcfg, tcfg = cfgs(world_width=32.0, world_height=32.0, tile_cap=3,
                      initial_particles=200, max_particles=200)
    pos, rad, prev = scene(200, 17, w=32.0, h=32.0)
    a, b = both_states(jcfg, tcfg, pos, rad, prev)
    a, b = teleport(a, b, np.random.default_rng(5), 1.2)
    return jcfg, tcfg, a, b


@functools.lru_cache(maxsize=None)
def _jax_k4():
    """The JAX ``relocate_pallas_one`` of the scene (interpret mode,
    compiled once at XLA:CPU optimisation level 0)."""
    jcfg, _, a, _ = _k4_scene()
    fn = jax.jit(relocate_pallas_one, static_argnums=(1,),
                 compiler_options={"xla_backend_optimization_level": 0})
    return fn(a, jcfg)


@pytest.mark.parametrize("match, hysteresis", [
    ("flip", 0.0), ("greedy", -1.0), ("flip2", 0.3)])
def test_k4_plain_matches_jax_relocate_pallas_one(match, hysteresis):
    """Every field and overflow_count bit for bit, whatever the config's
    tiled_match and hysteresis say (K4 matches by flip, without
    hysteresis); and equal to K2's plain version under flip, delta 0."""
    _, tcfg, _, b = _k4_scene()
    c = tcfg.replace(tiled_match=match, tiled_hysteresis=hysteresis)
    got = tk.relocate_one(b, c)
    assert_same(_jax_k4(), got)
    k2 = tk.relocate_pull_plain(b, tcfg.replace(tiled_match="flip",
                                                tiled_hysteresis=0.0))[0]
    for f in FIELDS + ("overflow_count",):
        assert torch.equal(getattr(got, f), getattr(k2, f)), f
    moved = int((got.pid != b.pid).sum())
    assert moved > 0 and int(got.overflow_count) > 0


def _edge_particle(t, TX):
    """(x, home, step): the first x among f32(k * t) and its two f32
    neighbours whose home tile by the division, floor(x / t) + 1, is not
    where the products put it: K2 stores a particle of tile ``home`` that
    is ``step`` tiles off by x >= f32(s * t) and x < f32((s - 1) * t)."""
    t32 = np.float32(t)
    for k in range(1, TX - 2):
        p = np.float32(k * t32)
        for x in (p, np.nextafter(p, np.float32(np.inf)),
                  np.nextafter(p, np.float32(-np.inf))):
            s = int(np.floor(x / t32)) + 1
            step = (int(x >= np.float32(np.float32(s) * t32))
                    - int(x < np.float32(np.float32(s - 1) * t32)))
            if step and 2 <= s <= TX - 3:
                return x, s, step
    raise AssertionError("no edge particle in this grid")


def test_k4_and_k2_part_within_an_ulp_of_a_tile_edge():
    """A particle within an ulp of a tile edge, stored in its home tile by
    the division (moved there after the tiling): K4 keeps it there, K2
    (flip, delta 0) moves it one tile, as the JAX kernels do
    (``_home_tile`` against ``_step_offsets``)."""
    _, tcfg = cfgs(world_width=32.0, world_height=16.0, tile_cap=3,
                   initial_particles=1, max_particles=1)
    t, TY, TX = tt.tile_geometry(tcfg)
    x, home, step = _edge_particle(t, TX)
    assert int(tt._tile_of(torch.tensor([x]), torch.tensor([8.0]),
                           t)[1]) == home
    st = tt.init_tiles(tcfg, np.array([[(home - 0.5) * t, 8.0]], np.float32),
                       np.full(1, 0.5, np.float32))
    assert torch.nonzero(st.pid >= 0)[0, 2].item() == home
    st = st.replace(x=torch.where(st.pid >= 0, torch.tensor(x), st.x))
    k4 = tk.relocate_one(st, tcfg)
    k2 = tk.relocate_pull_plain(st, tcfg.replace(tiled_match="flip",
                                                 tiled_hysteresis=0.0))[0]
    assert torch.nonzero(k4.pid >= 0)[0, 2].item() == home
    assert torch.nonzero(k2.pid >= 0)[0, 2].item() == home + step


@pytest.mark.parametrize("edge", [3.3, 1.65])
def test_tile_of_divides_on_edge_probes(edge):
    """``_tile_of`` is numpy's f32 floor(x / t) + 1 and the JAX package's
    ``_tile_of`` on the probes k * t (k < 2000) and their two f32
    neighbours, where the reciprocal form floor(x * (1 / t)), which
    PyTorch's CUDA division by a Python float computes, puts some probes
    in the other tile."""
    t = np.float32(edge)
    k = np.arange(2000, dtype=np.float32)
    p = k * t
    x = np.concatenate([p, np.nextafter(p, np.float32(np.inf)),
                        np.nextafter(p, np.float32(-np.inf))])
    x = x[x >= 0].astype(np.float32)
    y = x[::-1].copy()
    want_x = (np.floor(x / t) + 1).astype(np.int32)
    want_y = (np.floor(y / t) + 1).astype(np.int32)
    ty, tx = tt._tile_of(torch.from_numpy(x), torch.from_numpy(y), edge)
    np.testing.assert_array_equal(tx.numpy(), want_x)
    np.testing.assert_array_equal(ty.numpy(), want_y)
    jty, jtx = jt._tile_of(jnp.asarray(x), jnp.asarray(y), jnp.float32(t))
    np.testing.assert_array_equal(np.asarray(jtx), want_x)
    np.testing.assert_array_equal(np.asarray(jty), want_y)
    recip = (np.floor(x * (np.float32(1) / t)) + 1).astype(np.int32)
    assert (recip != want_x).sum() > 0
