"""The port's plain K1 and K2 past cap 256, and K2's greedy plan by prefix
counts, against the JAX package on the CPU, where no CUDA kernel runs.

  * ``tiled_kernels._greedy_plain`` (the greedy matching as two prefix
    counts: the i-th free slot of a tile, ascending, takes the i-th mover
    in (neighbour, slot) order) equals the sequential loop it replaced
    (kept here, ``_greedy_loop``) on random claims at caps up to 16, and
    the plain plan under greedy equals the JAX package's ``_plan_choose``
    (its matching core, run op by op over the same neighbour views) at
    caps up to 8.
  * At cap 257, on a 6 x 8 grid whose densest tile holds slots past 255,
    K1's plain version equals the JAX package's collide and integrate
    (their jnp path) within 1e-5 world units, as at cap 48
    (test_torch_cap.py).
  * On the same scene teleported by up to 0.9 tile, K2's plain version
    ``relocate_pull_plain`` in flip and flip2 equals the JAX package's
    ``_plan_choose`` and ``_apply_merge`` (the pull relocate's plan and
    apply cores) exactly: the plan, pid, the deferrals and
    overflow_count.  JAX's apply runs over pid alone (its field loops are
    per field, so every field moves by the same selects); x, y, px, py
    and radius are held by pid: every output slot holds its particle's
    input values, empty slots zero.

The JAX functions run op by op: compiled, their unrolled loops take
minutes at cap 257.  The scene, its JAX neighbour views and step offsets
are built once for the file.  The CUDA kernels at these caps are held to
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu.core.state import StepParams as JParams
from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_tpu.ops import tiled_pallas as tp
from gpu_physics_engine_torch import StepParams as TParams
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.ops import tiled_kernels as tk
from test_torch_tiled import assert_same, both_states, cfgs, teleport

CAP = 257


def _greedy_loop(claims, free):
    """The greedy plan's sequential form: for each free slot k ascending,
    the first (neighbour e, slot s) mover not yet claimed."""
    _, cap, TY, TX = claims.shape
    chosen = torch.full((cap, TY, TX), -1, dtype=torch.int32)
    claimed = torch.zeros_like(claims)
    for k in range(cap):
        ck = chosen[k]
        for e in range(8):
            for s in range(cap):
                take = free[k] & claims[e, s] & ~claimed[e, s] & (ck < 0)
                ck = torch.where(take, torch.full_like(ck, e * cap + s), ck)
                claimed[e, s] |= take
        chosen[k] = ck
    return chosen


@pytest.mark.parametrize("cap", [1, 2, 3, 8, 13, 16])
def test_greedy_prefix_equals_loop(cap):
    g = torch.Generator().manual_seed(cap)
    for p in (0.05, 0.3, 0.8):
        claims = torch.rand((8, cap, 4, 5), generator=g) < p
        free = torch.rand((cap, 4, 5), generator=g) < 0.5
        assert torch.equal(tk._greedy_plain(claims, free),
                           _greedy_loop(claims, free))


def _scene(cap, n, seed, w=8.0, h=8.0):
    """``n`` particles at ``cap`` on a ``w`` x ``h`` world, three fifths
    of them in a pile whose densest tile passes slot 255 at cap 257 with
    700, in both packages."""
    jcfg, tcfg = cfgs(tile_cap=cap, world_width=w, world_height=h,
                      max_particles=n, initial_particles=n,
                      gravity=(0.0, -9.8))
    rng = np.random.default_rng(seed)
    pile = 3 * n // 5
    pos = np.concatenate([
        rng.uniform(0.6, [w - 0.6, h - 0.6], (n - pile, 2)),
        np.clip([w / 2, h / 2] + rng.normal(0, 0.6, (pile, 2)), 0.6,
                [w - 0.6, h - 0.6])]).astype(np.float32)
    rad = rng.uniform(0.2, 0.3, n).astype(np.float32)
    prev = (pos + rng.normal(0, 0.05, pos.shape)).astype(np.float32)
    a, b = both_states(jcfg, tcfg, pos, rad, prev)
    return jcfg, tcfg, a, b


def _views(st, TY, TX):
    """JAX ``_plan_choose``'s neighbour views of a state (the port's
    shifted planes, each in-grid mask), and the tile coordinates."""
    my_ty = jnp.arange(TY, dtype=jnp.int32).reshape(1, TY, 1)
    my_tx = jnp.arange(TX, dtype=jnp.int32).reshape(1, 1, TX)
    views = []
    for ey, ex in tp._NEIGHBORS:
        valid = ((my_ty + ey >= 0) & (my_ty + ey <= TY - 1)
                 & (my_tx + ex >= 0) & (my_tx + ex <= TX - 1))
        sh = {n: jnp.asarray(tt.shift_tiles(getattr(st, n), ey, ex).numpy())
              for n in tt.FIELDS}
        views.append((sh, valid, ey, ex))
    return views, my_ty, my_tx


def _j_plan(st, jcfg, match, views=None):
    """The JAX plan over the port's state ``st``: ``_plan_choose``, free
    and interior slots only, i32 [cap, TY, TX]; with the neighbour views
    and tile coordinates (``views``, built here unless given)."""
    cap, TY, TX = st.dims
    t = jt.tile_geometry(jcfg)[0]
    views, my_ty, my_tx = views or _views(st, TY, TX)
    pid = jnp.asarray(st.pid.numpy())
    chosen = tp._plan_choose(
        [(v["x"], v["y"], v["pid"], ok, ey, ex) for v, ok, ey, ex in views],
        pid, my_ty, my_tx, cap=cap, t=t, gTY=TY, gTX=TX, match=match,
        delta=jcfg.hysteresis_delta)
    interior = ((my_ty >= 1) & (my_ty <= TY - 2) & (my_tx >= 1)
                & (my_tx <= TX - 2))
    return jnp.where((pid < 0) & interior, jnp.concatenate(chosen, axis=0),
                     -1), views, my_ty, my_tx


@pytest.mark.parametrize("cap", [2, 5, 8])
def test_greedy_plan_matches_jax(cap):
    jcfg, tcfg, _, b = _scene(cap, 150, cap, w=24.0, h=24.0)
    _, b = teleport(_, b, np.random.default_rng(cap),
                    0.9 * tt.tile_geometry(tcfg)[0])
    _, TY, TX = b.dims
    t = tt.tile_geometry(tcfg)[0]
    offsets = functools.partial(tt.step_offsets, t=t,
                                delta=tcfg.hysteresis_delta, gTY=TY, gTX=TX)
    got = tk._plan_plain(b, "greedy", offsets, 0, TY)
    want = _j_plan(b, jcfg, "greedy")[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got >= 0).sum()) > 0  # the scene pulls movers


@pytest.fixture(scope="module")
def scene257():
    """The cap-257 scene of the K1 and K2 cases."""
    return _scene(CAP, 700, 5)


@pytest.fixture(scope="module")
def moved257(scene257):
    """The cap-257 scene teleported by up to 0.9 tile (the port's state),
    its JAX neighbour views and tile coordinates, and JAX's per-slot step
    offsets and mover gates (``_step_offsets`` a slot, as the flat
    relocate computes them): what the K2 cases share."""
    jcfg, tcfg, a, b = scene257
    _, b = teleport(a, b, np.random.default_rng(6),
                    0.9 * tt.tile_geometry(tcfg)[0])
    cap, TY, TX = b.dims
    views, my_ty, my_tx = _views(b, TY, TX)
    t = jt.tile_geometry(jcfg)[0]
    x, y = (jnp.asarray(v.numpy()) for v in (b.x, b.y))
    pid = jnp.asarray(b.pid.numpy())
    dty, dtx, moving = [], [], []
    for k in range(cap):
        oy, ox = tp._step_offsets(x[k:k + 1], y[k:k + 1], my_ty, my_tx, t=t,
                                  delta=jcfg.hysteresis_delta, gTY=TY,
                                  gTX=TX)
        dty.append(oy)
        dtx.append(ox)
        moving.append((pid[k:k + 1] >= 0) & (my_ty + oy >= 0)
                      & (my_ty + oy <= TY - 1) & ((oy != 0) | (ox != 0)))
    return b, (views, my_ty, my_tx), (dty, dtx, moving)


def test_k1_plain_past_256_matches_jax(scene257):
    jcfg, tcfg, a, b = scene257
    assert int((b.pid >= 0).sum(0).max()) > 256  # slots past 255 in use
    pa = JParams.make(0.02, mouse=(3.0, 5.0), pressed=True)
    pb = TParams.make(0.02, mouse=(3.0, 5.0), pressed=True)
    ja = jt.integrate(jt.collide(a, jcfg), pa, jcfg)
    tb = tk.collide_integrate(b, pb.as_tensor("cpu"), tcfg)
    assert_same(ja, tb, atol=1e-5)
    assert tk.LAUNCHES["collide_integrate"] == 0  # CPU: no kernel launch


@pytest.mark.parametrize("match", ["flip", "flip2"])
def test_k2_plain_past_256_matches_jax(scene257, moved257, match):
    jcfg, tcfg = (c.replace(tiled_match=match) for c in scene257[:2])
    b, geo, (dty, dtx, moving) = moved257
    assert int((b.pid >= 0).sum(0).max()) > 256
    plan, views, _, _ = _j_plan(b, jcfg, match, geo)
    mids = {"pid": jnp.asarray(b.pid.numpy()), "plan": plan}
    plan_t = torch.from_numpy(np.array(plan))
    nbr = [({"pid": v["pid"]},
            jnp.asarray(tt.shift_tiles(plan_t, ey, ex).numpy()), ey, ex)
           for (v, _, ey, ex) in views]
    out, defer = tp._apply_merge(mids, nbr, moving, dty, dtx, cap=CAP,
                                 match=match, fields=("pid",))
    got, gdefer = tk.relocate_pull_plain(b, tcfg)
    np.testing.assert_array_equal(
        got.pid.numpy(), np.asarray(jnp.concatenate(out["pid"], axis=0)))
    live, src = got.pid >= 0, b.pid >= 0
    order = torch.argsort(b.pid[src])
    for n in ("x", "y", "px", "py", "radius"):
        by_pid = getattr(b, n)[src][order]  # the input value of pid p at p
        want = torch.where(live, by_pid[got.pid.clamp(min=0).long()], 0.0)
        assert torch.equal(getattr(got, n), want), n
    np.testing.assert_array_equal(gdefer.numpy(), np.asarray(defer[0]))
    assert int(got.overflow_count) == int(b.overflow_count) + int(
        np.asarray(defer).sum())
    assert int(gdefer.sum()) > 0 and int((got.pid != b.pid).sum()) > 0
