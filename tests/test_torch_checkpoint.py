"""The port's checkpoints (gpu_physics_engine_torch/utils/checkpoint.py and
TiledEngine.save_checkpoint / from_checkpoint) against the JAX package's
format, on the CPU.

A file written by either package loads in the other: the config, the
pids, every float and the overlay's bigs equal exactly (no arithmetic on
the way).  An array checkpoint written mid-way through the Morton resort
cadence resumes exactly as the engine that did not stop (the JAX
package's tests/test_aux.py lock).  No JAX compile: the JAX side only
writes, reads and re-tiles on the host.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from gpu_physics_engine_tpu.core import state as jstate
from gpu_physics_engine_tpu.ops import bigs as jbigs
from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_tpu.utils import checkpoint as jck
from gpu_physics_engine_torch import Engine, SimConfig
from gpu_physics_engine_torch.core import state as tstate
from gpu_physics_engine_torch.core.tiled_engine import TiledEngine as TEngine
from gpu_physics_engine_torch.ops import bigs as tbigs
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.utils import checkpoint as tck
from test_torch_tiled import assert_same, cfgs, scene


def _equal(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def _spawned(tcfg):
    """A port engine with 200 tile particles and 30 bigs in the overlay
    (radius 1-3 against tiles sized for 0.5), run 5 steps."""
    pos, rad, prev = scene(200, 7)
    e = TEngine.from_arrays(tcfg, pos, rad, previous_positions=prev,
                            device="cpu")
    e.spawn_at((32.0, 32.0), count=30, verbose=False)
    e.run(5)
    assert int(e.big.num_active) == 30
    return e


def test_tiled_checkpoint_written_by_the_port_loads_in_jax(tmp_path):
    jcfg, tcfg = cfgs(initial_particles=200)
    e = _spawned(tcfg)
    path = str(tmp_path / "port.npz")
    e.save_checkpoint(path)
    cfg = jck.peek_tiled_config(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(e.config)
    jstate_, _ = jck.load_tiled_checkpoint(path)
    _equal(jt.export_particles(jstate_), tt.export_particles(e.state))
    assert int(jstate_.overflow_count) == int(e.state.overflow_count)
    _equal(jck.load_tiled_bigs(path), tbigs.export_bigs(e.big))
    # both packages re-tile the stored arrays into the same slots
    back = TEngine.from_checkpoint(path, device="cpu")
    assert_same(jstate_, back.state)
    _equal(back._export(), e._export())


def test_tiled_checkpoint_written_by_jax_loads_in_the_port(tmp_path):
    jcfg, tcfg = cfgs(initial_particles=200)
    pos, rad, prev = scene(200, 8)
    st = jt.init_tiles(jcfg, pos, rad, previous_positions=prev)
    st = dataclasses.replace(st, overflow_count=jnp.int32(17))
    rng = np.random.default_rng(8)
    big = jbigs.init_bigs(128)
    bpos = rng.uniform(5.0, 59.0, (12, 2)).astype(np.float32)
    big = dataclasses.replace(
        big, x=big.x.at[3:15].set(bpos[:, 0]),
        y=big.y.at[3:15].set(bpos[:, 1]),
        px=big.px.at[3:15].set(bpos[:, 0] - 0.01),
        py=big.py.at[3:15].set(bpos[:, 1] + 0.02),
        radius=big.radius.at[3:15].set(rng.choice([1.0, 2.0, 3.0], 12)),
        pid=big.pid.at[3:15].set(np.arange(214, 202, -1, dtype=np.int32)),
        num_active=jnp.int32(12))
    path = str(tmp_path / "jax.npz")
    jck.save_tiled_checkpoint(path, st, jcfg, big=big)
    e = TEngine.from_checkpoint(path, device="cpu")
    assert dataclasses.asdict(e.config) == dataclasses.asdict(jcfg)
    assert_same(st, e.state)
    assert int(e.state.overflow_count) == 17
    _equal(tbigs.export_bigs(e.big), jbigs.export_bigs(big))
    assert e.num_particles() == 212 and e._next_pid == 215
    e.run(3)
    assert e.num_particles() == 212


def test_peek_with_overrides_retiles_under_the_new_geometry(tmp_path):
    jcfg, tcfg = cfgs(initial_particles=200)
    e = _spawned(tcfg)
    path = str(tmp_path / "c")  # numpy appends .npz, as in JAX
    e.save_checkpoint(path)
    path += ".npz"
    over = dict(tile_cap=6, tile_multiplier=5.0)
    back = TEngine.from_checkpoint(path, device="cpu", **over)
    assert back.config == tck.peek_tiled_config(path).replace(**over)
    want, _ = jck.load_tiled_checkpoint(
        path, config=jck.peek_tiled_config(path).replace(**over))
    assert back.state.dims == tuple(want.pid.shape) != e.state.dims
    assert_same(want, back.state)
    _equal(back._export(), e._export())


def test_array_checkpoint_resumes_mid_cadence(tmp_path):
    """Saved 2 steps past a resort with a cadence of 4: the resumed engine
    resorts at the same step as the one that did not stop, bit for bit."""
    cfg = SimConfig(max_particles=512, initial_particles=256,
                    world_width=64.0, world_height=64.0, initial_radius=0.5,
                    sort_interval_steps=4)
    eng = Engine(cfg, seed=0, device="cpu")
    eng.press_mouse((32.0, 32.0))
    eng.run(6)
    path = str(tmp_path / "array.npz")
    tck.save_checkpoint(path, eng.state, eng.config)
    state2, cfg2 = tck.load_checkpoint(path, device="cpu")
    assert cfg2 == eng.config and int(state2.steps_since_sort) == 2
    eng2 = Engine(cfg2, initial_state=state2)
    eng2.press_mouse((32.0, 32.0))
    a, b = eng.run(5), eng2.run(5)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    # the same file in the JAX package, and back
    js, jcfg = jck.load_checkpoint(path)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg2)
    for f, v in tstate.to_numpy(state2).items():
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), v,
                                      err_msg=f)
    jck.save_checkpoint(str(tmp_path / "jax.npz"), js, jcfg)
    st3, cfg3 = tck.load_checkpoint(str(tmp_path / "jax.npz"), device="cpu")
    assert cfg3 == cfg2
    for f in dataclasses.fields(st3):
        assert torch.equal(getattr(st3, f.name), getattr(state2, f.name))


def test_array_checkpoint_of_a_jax_state_with_colors(tmp_path):
    jcfg, tcfg = cfgs(track_colors=True, pipeline="sorted")
    pos, rad, prev = scene(100, 9)
    colors = np.random.default_rng(9).uniform(0, 1, (100, 4))
    js = jstate.from_arrays(jcfg, pos, rad, previous_positions=prev,
                            colors=colors)
    path = str(tmp_path / "colors.npz")
    jck.save_checkpoint(path, js, jcfg)
    st, cfg = tck.load_checkpoint(path, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    assert st.color.shape == (tcfg.capacity, 4)
    for f, v in tstate.to_numpy(st).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, f)),
                                      err_msg=f)
