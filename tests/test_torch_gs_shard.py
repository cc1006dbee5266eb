"""The port's sharded Gauss-Seidel frame (parallel/gs_shard.py), a
bitwise prototype: on 2 and 4 slabs it equals the port's single-grid
``gs_tiled.gs_solve`` and the JAX package's ``make_sharded_gs_solve`` (on
2 and 4 of the 8 virtual CPU devices) bit for bit, overflow included.
Cap 2 and K 3 keep the JAX compile short (it grows with cap x K)."""

import functools

import jax
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu import SimConfig as JConfig
from gpu_physics_engine_tpu.parallel import gs_shard as jgs
from gpu_physics_engine_tpu.parallel import mesh as jmesh
from gpu_physics_engine_tpu.parallel import tiled_shard as jts
from gpu_physics_engine_torch import SimConfig as TConfig
from gpu_physics_engine_torch.ops import gs_tiled, tiled
from gpu_physics_engine_torch.parallel import gs_shard as tgs
from gpu_physics_engine_torch.parallel import mesh as tmesh
from gpu_physics_engine_torch.parallel import tiled_shard as tts


def cfgs(**kw):
    base = dict(max_particles=512, initial_particles=0, world_width=24.0,
                world_height=24.0, initial_radius=0.5, pipeline="tiled",
                tiled_solver="gs", tile_multiplier=2.2, tile_cap=2,
                max_occupancy=3)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def scene(n=180, seed=17):
    """Dense enough for cross-boundary pairs and the K clamp."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0.8, 23.2, n), rng.uniform(0.8, 23.2, n)],
                   -1).astype(np.float32)
    return pos, np.full(n, 0.5, np.float32)


@functools.lru_cache(maxsize=None)
def solved(n_slabs):
    """(port single-grid frame, port sharded frame gathered, JAX sharded
    frame planes)."""
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    jc, tc = cfgs()
    pos, rad = scene()
    ref = gs_tiled.gs_solve(tiled.init_tiles(tc, pos, rad), tc)
    mesh = tmesh.make_mesh(n_slabs, device="cpu")
    out = tgs.make_sharded_gs_solve(tc, mesh)(
        tts.init_sharded_tiles(tc, mesh, pos, rad))
    jm = jmesh.make_mesh(n_slabs)
    js = jgs.make_sharded_gs_solve(jc, jm)(
        jts.init_sharded_tiles(jc, jm, pos, rad))
    jd = {f: np.asarray(getattr(js, f)) for f in tiled.FIELDS}
    jd["overflow_count"] = int(js.overflow_count)
    return ref, tmesh.gather_tiles(out), jd


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_sharded_gs_equals_single_grid_solve_bitwise(n_slabs):
    ref, out, _ = solved(n_slabs)
    TY = ref.dims[1]
    for f in tiled.FIELDS:
        assert torch.equal(getattr(out, f)[:, :TY], getattr(ref, f)), f
    assert bool((out.pid[:, TY:] < 0).all())  # slab pad rows stay empty
    assert int(out.overflow_count) == int(ref.overflow_count) > 0
    moved = (out.pid >= 0) & (out.x != tiled.init_tiles(
        cfgs()[1], *scene()).x)
    assert int(moved.sum()) > 20  # the solve did move particles


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_sharded_gs_equals_jax_bitwise(n_slabs):
    _, out, jd = solved(n_slabs)
    for f in tiled.FIELDS:
        np.testing.assert_array_equal(getattr(out, f).numpy(), jd[f],
                                      err_msg=f)
    assert int(out.overflow_count) == jd["overflow_count"]


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_bytes_per_frame_equals_jax(n_slabs):
    jc, tc = cfgs()
    assert tgs.bytes_per_frame(tc, n_slabs) == jgs.bytes_per_frame(
        jc, n_slabs)
    bill = tgs.bytes_per_frame(tc, n_slabs)
    row_block = tc.tile_cap * 2 * bill["tile_cols"] * 4
    assert bill["total_bytes_per_frame"] == (5 + 6) * row_block * 2


def test_too_thin_slabs_refused():
    jc, tc = cfgs(world_height=8.0)  # 10 tile rows over 8 slabs
    with pytest.raises(AssertionError, match="ghost rows"):
        tgs.make_sharded_gs_solve(tc, tmesh.make_mesh(8, device="cpu"))
    with pytest.raises(AssertionError, match="ghost rows"):
        jgs.make_sharded_gs_solve(jc, jmesh.make_mesh(8))


def test_row_origin_keyword_leaves_single_grid_calls_unchanged():
    """``memberships`` and the color passes at row0 = 0 are the existing
    single-grid calls; an even row0 changes no color; at an odd row0
    color 1 runs the rows of color 3 (and 2 those of 4)."""
    _, tc = cfgs()
    st = tiled.init_tiles(tc, *scene())
    t = tiled.tile_geometry(tc)[0]
    for a, b in zip(gs_tiled.memberships(st, t),
                    gs_tiled.memberships(st, t, row0=0)):
        assert torch.equal(a, b)
    src, _, rrad, _ = gs_tiled.rank_plain(st, tc)

    def one(color, row0):
        x, y = st.x.clone(), st.y.clone()
        gs_tiled.color_plain_(x, y, src, rrad, tc, color, row0=row0)
        return x, y

    x0, y0 = st.x.clone(), st.y.clone()
    gs_tiled.color_plain_(x0, y0, src, rrad, tc, 1)
    for c in (1, 2, 3, 4):
        a, b = one(c, 0), one(c, 2)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(x0, one(1, 0)[0]) and torch.equal(y0, one(1, 0)[1])
    for c, c_odd in ((1, 3), (2, 4), (3, 1)):
        a, b = one(c, 1), one(c_odd, 0)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(one(1, 0)[0], one(3, 0)[0])
