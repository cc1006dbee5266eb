"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only, so it also runs where jax is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
repository's conftest imports jax).  Without a CUDA device every test here
skips.  K1 and K3 agree with their plain versions within 1e-5 (rsqrt
rounding); K2, K5 and K6 bit for bit.
"""

import numpy as np
import pytest
import torch

from gpu_physics_engine_torch import SimConfig, StepParams
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.ops import tiled_kernels as tk

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs a CUDA device")]

FIELDS = tt.FIELDS


def _scene(match="greedy", hysteresis=0.0, cap=4, uniform=True, n=500,
           jitter=1.0, **kw):
    cfg = SimConfig(max_particles=n, initial_particles=n, world_width=64.0,
                    world_height=64.0, pipeline="tiled", tile_cap=cap,
                    tiled_match=match, tiled_hysteresis=hysteresis,
                    tiled_uniform_radius=uniform, **kw)
    rng = np.random.default_rng(cap)
    pos = rng.uniform(0.6, 63.4, (n, 2)).astype(np.float32)
    rad = (np.full(n, 0.5, np.float32) if uniform
           else rng.uniform(0.3, 0.5, n).astype(np.float32))
    prev = (pos + rng.normal(0, 0.05, pos.shape)).astype(np.float32)
    st = tt.init_tiles(cfg, pos, rad, previous_positions=prev, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(cap)
    occ = st.pid >= 0
    d = (torch.rand(st.x.shape, generator=g, device="cuda") - 0.5) * 2 * jitter
    return cfg, st.replace(x=torch.where(occ, st.x + d, st.x))


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("world", ["box", "circle"])
def test_k1_cuda_matches_plain(uniform, world):
    cfg, st = _scene(uniform=uniform, jitter=0.0, world_shape=world,
                     gravity=(0.0, -9.8))
    prm = StepParams.make(0.02, mouse=(30.0, 20.0), pressed=True).as_tensor(
        "cuda")
    n0 = tk.LAUNCHES["collide_integrate"]
    a = tk.collide_integrate(st, prm, cfg)
    b = tk.collide_integrate_plain(st, prm, cfg)
    c = tk.collide_integrate(st, prm, cfg)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["collide_integrate"] == n0 + 2
    for f in ("x", "y", "px", "py"):
        assert float((getattr(a, f) - getattr(b, f)).abs().max()) < 1e-5, f
        assert torch.equal(getattr(a, f), getattr(c, f)), f  # deterministic
    assert torch.equal(a.pid, b.pid)


@pytest.mark.parametrize("match", ["flip", "flip2", "greedy"])
@pytest.mark.parametrize("hysteresis", [0.0, -1.0])
@pytest.mark.parametrize("cap", [4, 8])
def test_k2_cuda_matches_plain(match, hysteresis, cap):
    cfg, st = _scene(match=match, hysteresis=hysteresis, cap=cap)
    n0 = tk.LAUNCHES["relocate_pull"]
    a, da = tk.relocate_pull_cuda(st, cfg)
    b, db = tk.relocate_pull_plain(st, cfg)
    c, dc = tk.relocate_pull_cuda(st, cfg)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["relocate_pull"] == n0 + 2
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(a, f), getattr(c, f)), f
    assert torch.equal(da, db) and torch.equal(da, dc)
    assert int((a.pid >= 0).sum()) == 500  # nothing lost


@pytest.mark.parametrize("uniform", [False, True])
def test_k3_cuda_matches_plain(uniform):
    cfg, st = _scene(uniform=uniform, jitter=0.3)
    n0 = tk.LAUNCHES["collide"]
    a = tk.collide(st, cfg)
    b = tk.collide_plain(st, cfg)
    c = tk.collide(st, cfg)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["collide"] == n0 + 2
    for f in ("x", "y"):
        assert float((getattr(a, f) - getattr(b, f)).abs().max()) < 1e-5, f
        assert torch.equal(getattr(a, f), getattr(c, f)), f
    for f in ("px", "py", "radius", "pid"):
        assert torch.equal(getattr(a, f), getattr(st, f)), f


def _gs_scene(cap, K, seed):
    """Mixed radii over the world plus a jammed cluster (cells past K),
    stored up to a third of a tile off home as after the pull relocate."""
    from gpu_physics_engine_torch.core.tuned import gs_config
    cfg = gs_config(1500, world_width=40.0, world_height=30.0, tile_cap=cap,
                    max_occupancy=K)
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.uniform(0.6, [39.4, 29.4], (1000, 2)),
                          np.clip([20.0, 15.0] + rng.normal(0, 2.0, (500, 2)),
                                  0.6, [39.4, 29.4])]).astype(np.float32)
    rad = rng.uniform(0.3, 0.5, 1500).astype(np.float32)
    st = tt.init_tiles(cfg, pos, rad, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    occ = st.pid >= 0
    d = (torch.rand(st.x.shape, generator=g, device="cuda") - 0.5) * 0.7
    return cfg, st.replace(x=torch.where(occ, st.x + d, st.x),
                           y=torch.where(occ, st.y - d, st.y))


@pytest.mark.parametrize("cap, K", [(4, 8), (6, 12), (2, 3)])
def test_gs_kernels_match_plain(cap, K):
    """K5's rank tables and K6's four colors bit-equal to the plain
    versions, clamp overflow included; deterministic on repeat."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    cfg, st = _gs_scene(cap, K, seed=cap)
    n0 = dict(gk.LAUNCHES)
    a, ta = gk.solve_frame(st, cfg, gk.rank, gk.color_)
    b, tb = gk.solve_frame(st, cfg, gk.rank_plain, gk.color_plain_)
    c, tc = gk.solve_frame(st, cfg, gk.rank, gk.color_)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["gs_rank"] == n0["gs_rank"] + 2
    assert gk.LAUNCHES["gs_color"] == n0["gs_color"] + 8
    for u, v, w in zip(ta, tb, tc):
        assert torch.equal(u, v) and torch.equal(u, w)
    for f in ("x", "y", "overflow_count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(a, f), getattr(c, f)), f
    assert int(a.overflow_count) > 0  # the jammed cluster clamps
    assert int((a.x != st.x).sum()) > 0


def test_gs_engine_on_card_matches_cpu_engine():
    """The GS step on the card (K2, K5, K6) against the same engine on the
    CPU (plain versions): pid placement and counters exact, positions
    close (the plain integrate's sqrt may round apart on the CPU)."""
    from gpu_physics_engine_torch import TiledEngine
    cfg, st = _gs_scene(4, 8, seed=9)
    pid, pos, _, rad = tt.export_particles(st)
    engines = [TiledEngine.from_arrays(cfg, pos, rad, device=d)
               for d in ("cpu", "cuda")]
    for e in engines:
        e.press_mouse((20.0, 15.0))
        e.run(10)
    a, b = (tt.to_numpy(e.state) for e in engines)
    np.testing.assert_array_equal(a["pid"], b["pid"])
    assert int(a["overflow_count"]) == int(b["overflow_count"])
    for f in ("x", "y", "px", "py"):
        np.testing.assert_allclose(a[f], b[f], atol=1e-4, rtol=0)


def test_engine_on_card_matches_cpu_engine():
    """The whole step on the card (kernels) against the same engine on the
    CPU (plain versions): pid placement exact, positions close."""
    cfg = SimConfig(max_particles=300, initial_particles=300,
                    world_width=16.0, world_height=60.0, pipeline="tiled",
                    tile_cap=4, tiled_newton=True, tiled_uniform_radius=True,
                    tiled_relocate_interval=2, sort_interval_steps=6,
                    tiled_match="greedy")
    rng = np.random.default_rng(5)
    pos = np.stack([rng.uniform(0.6, 15.4, 300),
                    rng.uniform(0.6, 59.4, 300)], -1).astype(np.float32)
    rad = np.full(300, 0.5, np.float32)
    from gpu_physics_engine_torch import TiledEngine
    engines = [TiledEngine.from_arrays(cfg, pos, rad, device=d)
               for d in ("cpu", "cuda")]
    for e in engines:
        e.press_mouse((8.0, 20.0))
        e.run(12)
    a, b = (tt.to_numpy(e.state) for e in engines)
    np.testing.assert_array_equal(a["pid"], b["pid"])
    assert int(a["overflow_count"]) == int(b["overflow_count"])
    for f in ("x", "y", "px", "py"):
        np.testing.assert_allclose(a[f], b[f], atol=1e-4, rtol=0)
