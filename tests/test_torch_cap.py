"""Tile caps past 32 on the CPU, where no CUDA kernel runs (the card's
kernels keep a tile's slots in a 64-bit mask from cap 33 to 64, and past
64 keep no mask at all: no kernel has a largest cap).

  * ``tiled_kernels.check_card_cap``: every cap from 1 passes on a CUDA
    device, 257 and 300 included; 0 and below, and a cap whose slots pass
    the int32 index, raise naming the limit; on the CPU every cap passes.
    (Test names that say 64 date from the 64-slot limit.)
  * ``tiled_kernels.grown_cap``: the watchdog's and ``tiled_auto_cap_pct``'s
    growth takes cap + 1 on the card as on the CPU, past 256 too.
  * K1's plain version at cap 48 against the JAX package's collide and
    integrate (its jnp path: the interpret-mode Pallas kernels compile for
    minutes at that cap) on a pile whose tiles fill every slot, within
    1e-5 world units, pid exact.
  * A re-tiling spawn whose scene-sized cap passes 64, and one whose cap
    passes 256, are taken on the card as on the CPU (their caps pass the
    card's check); one whose slots would pass the int32 index is refused
    before the engine changes.  The growth steps of the watchdog and of
    ``tiled_auto_cap_pct`` take cap 257 on the card (the card stood in for
    by the engine's device, the state built on the CPU).

The CUDA kernels at caps past 32 are held to their plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu.core.state import StepParams as JParams
from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_torch import SimConfig, StepParams as TParams
from gpu_physics_engine_torch import TiledEngine
from gpu_physics_engine_torch.ops import tiled_kernels as tk
from test_torch_tiled import assert_same, both_states, cfgs


@pytest.mark.parametrize("cap", [1, 32, 33, 48, 64, 65, 140, 144, 256])
def test_card_takes_caps_up_to_64(cap):
    """The card takes caps 1-256, as every cap from 1 (the name dates from
    the 64-slot limit)."""
    tk.check_card_cap(cap, torch.device("cuda"))
    tk.check_card_cap(cap, "cuda:0")
    tk.check_card_cap(cap, torch.device("cpu"))


@pytest.mark.parametrize("cap", [257, 300, 0, -1])
def test_card_refuses_caps_outside_1_to_64(cap):
    """The card takes caps 257 and 300 (no kernel has a largest cap) and
    refuses caps 0 and below, naming the limit; the CPU takes every cap
    (the name dates from the 64-slot limit)."""
    if cap >= 1:
        tk.check_card_cap(cap, torch.device("cuda"))
        tk.check_card_cap(cap, "cuda:0", 168 * 464)  # the 4M re-tile's grid
    else:
        with pytest.raises(ValueError, match=f"tile_cap {cap} outside 1 <= "
                                             "cap"):
            tk.check_card_cap(cap, torch.device("cuda"))
    tk.check_card_cap(cap, torch.device("cpu"))  # the plain versions: any
    # the only limit past 1: the int32 slot count, cap x TY x TX < 2^31
    tiles = 168 * 464
    tk.check_card_cap(2 ** 31 // tiles, "cuda", tiles)
    with pytest.raises(ValueError, match="2\\^31"):
        tk.check_card_cap(2 ** 31 // tiles + 1, "cuda", tiles)


def _pile(cap, n, seed):
    """``n`` particles in a pile on a 16 x 16 world at ``cap``: the densest
    tiles fill every slot, past slot 32."""
    jcfg, tcfg = cfgs(tile_cap=cap, world_width=16.0, world_height=16.0,
                      max_particles=n, initial_particles=n,
                      gravity=(0.0, -9.8))
    rng = np.random.default_rng(seed)
    pos = np.clip(np.array([8.0, 8.0]) + rng.normal(0, 1.5, (n, 2)), 0.6,
                  15.4).astype(np.float32)
    rad = rng.uniform(0.2, 0.3, n).astype(np.float32)
    prev = (pos + rng.normal(0, 0.05, pos.shape)).astype(np.float32)
    return jcfg, tcfg, pos, rad, prev


def test_k1_plain_at_cap_48_matches_jax():
    jcfg, tcfg, pos, rad, prev = _pile(48, 1200, 5)
    a, b = both_states(jcfg, tcfg, pos, rad, prev)
    assert int((b.pid >= 0).sum(0).max()) == 48
    pa = JParams.make(0.02, mouse=(5.0, 9.0), pressed=True)
    pb = TParams.make(0.02, mouse=(5.0, 9.0), pressed=True)
    ja = jt.integrate(jt.collide(a, jcfg), pa, jcfg)
    tb = tk.collide_integrate(b, pb.as_tensor("cpu"), tcfg)
    assert_same(ja, tb, atol=1e-5)
    assert tk.LAUNCHES["collide_integrate"] == 0  # CPU: no kernel launch


def _retile_engine(n, world):
    """A CPU engine of ``n`` particles on a ``world`` x ``world`` world with
    tiled_spawn="retile" and the cap from its scene, after 2 steps."""
    cfg = SimConfig(max_particles=n + 100, initial_particles=n,
                    world_width=world, world_height=world, pipeline="tiled",
                    tile_cap=0, tiled_spawn="retile")
    e = TiledEngine(cfg, seed=0, device="cpu")
    e.run(2)
    return e


def test_retile_spawn_past_64_is_refused_on_the_card():
    """Past 64 and past 256 the card takes the re-tile, as the CPU does;
    a re-tile whose slots would pass the int32 index is refused before
    the engine changes (the name dates from the 64-slot limit)."""
    e = _retile_engine(4096, 64.0)
    e.spawn_at((32.0, 32.0), verbose=False)
    assert 64 < e.config.tile_cap <= 256 and e.num_particles() == 4196
    tk.check_card_cap(e.config.tile_cap, torch.device("cuda"))  # taken
    e = _retile_engine(1200, 16.0)  # the radius-3 tiles hold ~200 each
    e.spawn_at((8.0, 8.0), verbose=False)
    assert e.config.tile_cap > 256 and e.num_particles() == 1300
    tk.check_card_cap(e.config.tile_cap, torch.device("cuda"),
                      e.state.dims[1] * e.state.dims[2])  # taken
    e.run(2)
    assert np.isfinite(e.positions()).all()
    before = (e.config, e.state.dims, e._export(), e._next_pid)
    e.device = torch.device("cuda")  # the card, as check_card_cap sees it
    with pytest.raises(ValueError, match="2\\^31"):
        e._retile_cap(2 ** 31)  # past the int32 slot index on any grid
    assert (e.config, e.state.dims, e._next_pid) == (
        before[0], before[1], before[3])
    for u, v in zip(e._export(), before[2]):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("cap, device, want", [
    (1, "cuda", 2), (64, "cuda", 65), (140, "cuda", 141), (255, "cuda", 256),
    (256, "cuda", 257), (256, "cpu", 257), (300, "cpu", 301)])
def test_growth_stops_at_64_on_the_card(cap, device, want):
    """One slot of growth on the card as on the CPU, past 256 too (the
    name dates from the 64-slot limit, which held it)."""
    assert tk.grown_cap(cap, torch.device(device)) == want


def _jammed_engine(**kw):
    cfg = SimConfig(max_particles=150, initial_particles=150,
                    world_width=12.0, world_height=12.0, pipeline="tiled",
                    tile_cap=256, tiled_hysteresis=0.0, **kw)
    return TiledEngine(cfg, seed=0, device="cpu")


def _held(e, grow, monkeypatch):
    """Run ``grow`` with the engine seen as on the card (the card stood in
    for by the engine's device: the re-tile is asked for the card and
    built on the CPU): the cap grows to 257, as on the CPU."""
    from gpu_physics_engine_torch.core import tiled_engine as te
    asked, init = [], te.tiled.init_tiles

    def on_cpu(*args, device=None, **kw):
        asked.append(torch.device(device).type)
        return init(*args, device="cpu", **kw)
    monkeypatch.setattr(te.tiled, "init_tiles", on_cpu)
    n = e.num_particles()
    e.device = torch.device("cuda")
    grow(e)
    assert asked == ["cuda"]
    assert e.config.tile_cap == 257 and e.state.dims[0] == 257
    assert e.num_particles() == n


def test_auto_cap_growth_holds_at_64_on_the_card(monkeypatch):
    """tiled_auto_cap_pct's growth takes cap 257 on the card (the name
    dates from the 64-slot limit, which held it)."""
    e = _jammed_engine(tiled_auto_cap_pct=0.01)
    # a deferred population far past the bound over a 4-step window
    _held(e, lambda e: e._maybe_grow_cap(4, int(e.state.overflow_count)
                                         - 10_000), monkeypatch)


def test_watchdog_level_3_holds_at_64_on_the_card(monkeypatch):
    """The watchdog's level 3 grows cap 256 to 257 on the card (the name
    dates from the 64-slot limit, which held it)."""
    from gpu_physics_engine_torch.ops import tiled
    e = _jammed_engine(tiled_watchdog=True, tiled_watchdog_pct=1.0)
    stale = iter([10.0, 20.0, 40.0, 80.0, 1.0, 2.0])
    monkeypatch.setattr(tiled, "stale_pair_fraction",
                        lambda st, cfg: next(stale) / 100.0)
    e._wd_prev, e._wd_level, e._wd_retile_pct = 5.0, 2, None

    def level_3(e):
        events = e.watchdog_events
        e._watchdog()
        assert e.watchdog_events == events + 1 and e._wd_level == 2
    _held(e, level_3, monkeypatch)


@pytest.mark.parametrize("bad", ["positions", "previous_positions", "pids",
                                 "pids_2d"])
def test_init_tiles_refuses_arrays_of_other_lengths(bad):
    from gpu_physics_engine_torch.ops import tiled
    cfg = SimConfig(max_particles=8, initial_particles=8, world_width=16.0,
                    world_height=16.0, pipeline="tiled", tile_cap=4)
    rng = np.random.default_rng(0)
    args = dict(positions=rng.uniform(1, 15, (8, 2)),
                previous_positions=rng.uniform(1, 15, (8, 2)),
                pids=np.arange(8))
    if bad == "pids_2d":
        args["pids"] = np.arange(8).reshape(2, 4)
    else:
        args[bad] = args[bad][:-1]
    with pytest.raises(ValueError, match="8 radii"):
        tiled.init_tiles(cfg, radii=np.full(8, 0.5, np.float32), **args)
