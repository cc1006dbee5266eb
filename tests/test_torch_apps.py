"""The port's apps layer (gpu_physics_engine_torch/: scenes.py, app/headless,
app/web, app/interactive, utils/input, utils/profiling's Profiler and
phase breakdowns) against the JAX package's, on the CPU.

  * Every scene's SimConfig, steps and events equal to JAX's field by field.
  * ``apply_overrides`` on tests/test_aux.py's list gives configs equal to
    JAX's; a bad item raises SystemExit with JAX's message prefixes.
  * A small headless run of both CLIs (array Engine, a spawn, the
    attractor pressed and released, PNG frames, a chrome trace, a
    checkpoint): the same summary keys, the same particle count (spawns
    draw from each package's own generator, so only counts compare), the
    same frame files, and each package loads the other's checkpoint.
  * The whole slice: a JAX tiled checkpoint resumed by both CLIs
    (``--resume``, the attractor pressed and released, 8 steps,
    ``--checkpoint``), the plain stages on both sides (``--set
    tiled_collide=jnp --set tiled_relocate=jnp``); the end checkpoints'
    pids and overflow exactly, positions within 1e-4.
  * The Profiler's chrome-trace format; both phase breakdowns name every
    JAX phase (the JAX-to-port name map) and a failing phase raises.
  * InputManager makes the same engine calls as JAX's for one event script.
  * tests/test_web.py's three checks against the port's server on a CPU
    engine; the window app for 3 frames under Agg.

The JAX side compiles each program once in this file (module fixtures);
its breakdowns run with a stub for jit (their phase names only).
"""

import contextlib
import dataclasses
import functools
import http.client
import io
import json
import os
import threading
import time
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu import Engine as JArrayEngine
from gpu_physics_engine_tpu import SimConfig as JConfig
from gpu_physics_engine_tpu import scenes as jscenes
from gpu_physics_engine_tpu.app import headless as jheadless
from gpu_physics_engine_tpu.core.tiled_engine import TiledEngine as JEngine
from gpu_physics_engine_tpu.render.viewer import Viewer as JViewer
from gpu_physics_engine_tpu.utils import checkpoint as jckpt
from gpu_physics_engine_tpu.utils import input as jinput
from gpu_physics_engine_tpu.utils import profiling as jprof
from gpu_physics_engine_torch import SimConfig as TConfig
from gpu_physics_engine_torch import make_engine
from gpu_physics_engine_torch import scenes
from gpu_physics_engine_torch.app import headless
from gpu_physics_engine_torch.app.web import WebApp, make_server
from gpu_physics_engine_torch.core.tiled_engine import TiledEngine as TEngine
from gpu_physics_engine_torch.render.viewer import Viewer
from gpu_physics_engine_torch.utils import checkpoint as tckpt
from gpu_physics_engine_torch.utils import input as tinput
from gpu_physics_engine_torch.utils import profiling

def _quiet(fn, *args):
    """(fn(*args), what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


# ---------------------------------------------------------------------------
# scenes and --set
# ---------------------------------------------------------------------------

def test_scenes_match_jax():
    assert sorted(scenes.SCENES) == sorted(jscenes.SCENES) == [
        "four_million", "interactive", "million", "sixteen_million", "tiny"]
    for name, want in jscenes.SCENES.items():
        got = scenes.get_scene(name)
        assert got.name == want.name == name and got.steps == want.steps
        assert dataclasses.asdict(got.config) == dataclasses.asdict(
            want.config), name
        assert [dataclasses.astuple(e) for e in got.events] == \
            [dataclasses.astuple(e) for e in want.events], name
        assert got.config.capacity >= got.config.initial_particles
    four = scenes.get_scene("four_million").config
    assert (four.substeps, four.pipeline, four.tile_cap) == (2, "tiled", 8)
    with pytest.raises(KeyError, match="unknown scene"):
        scenes.get_scene("nope")


OVERRIDES = ["pipeline=tiled", "tile_cap=6", "tile_multiplier=3.3",
             "tiled_relocate_interval=2", "gs_layout=mx",
             "tiled_fuse_integrate=false", "gravity=0,-30",
             "render_supersample=2"]


@pytest.mark.parametrize("items", [OVERRIDES, ["tile_max_radius=1.5"],
                                   ["tile_max_radius=none", "substeps=2"]])
def test_apply_overrides_matches_jax(items):
    kw = dict(max_particles=128, initial_particles=64, world_width=64.0,
              world_height=64.0)
    got = headless.apply_overrides(TConfig(**kw), items)
    want = jheadless.apply_overrides(JConfig(**kw), items)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("item, prefix", [
    ("no_such_knob=1", "--set: unknown SimConfig field"),
    ("oops", "--set expects K=V")])
def test_apply_overrides_rejects_like_jax(item, prefix):
    cfg = TConfig(max_particles=128, initial_particles=64)
    for apply, c in ((headless.apply_overrides, cfg),
                     (jheadless.apply_overrides, JConfig(
                         max_particles=128, initial_particles=64))):
        with pytest.raises(SystemExit) as e:
            apply(c, [item])
        assert str(e.value).startswith(prefix)


def test_headless_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--particles", "16", "--steps", "1"],
                 ["--scene", "four_million"],
                 ["--particles", "16", "--steps", "1", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            headless.main(argv)


# ---------------------------------------------------------------------------
# the headless CLI, both packages
# ---------------------------------------------------------------------------

def _small_argv(d):
    return ["--particles", "200", "--steps", "8", "--world", "64", "64",
            "--sort-interval", "0", "--solver", "jacobi",
            "--spawn", "2", "32", "32",
            "--attract", "3", "32", "32", "--release", "6",
            "--render-every", "4", "--out", os.path.join(d, "frames"),
            "--chrometrace", os.path.join(d, "benchmark.json"),
            "--checkpoint", os.path.join(d, "end.npz"), "--summary-json",
            "--set", "max_occupancy=3"]  # jacobi, no resort: a short compile


@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    out = {}
    for name, main, extra in (("port", headless.main, ["--device", "cpu"]),
                              ("jax", jheadless.main, [])):
        d = str(tmp_path_factory.mktemp(name))
        summary, printed = _quiet(main, _small_argv(d) + extra)
        out[name] = (d, summary, printed)
    return out


def test_headless_small_run_matches_jax(small_runs):
    (td, got, printed), (jd, want, _) = small_runs["port"], small_runs["jax"]
    assert list(got) == list(want)
    assert got["particles"] == want["particles"] == 300
    assert got["steps"] == want["steps"] == 8
    assert got["finite"] and want["finite"]
    assert "Average update time" in printed
    assert json.loads(printed.strip().splitlines()[-1]) == got
    frames = sorted(os.listdir(os.path.join(td, "frames")))
    assert frames == sorted(os.listdir(os.path.join(jd, "frames"))) == [
        "frame_000000.png", "frame_000004.png"]
    with open(os.path.join(td, "frames", frames[1]), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    # each package loads the other's checkpoint
    st, cfg = jckpt.load_checkpoint(os.path.join(td, "end.npz"))
    assert int(st.num_active) == 300 and cfg.max_occupancy == 3
    st, cfg = tckpt.load_checkpoint(os.path.join(jd, "end.npz"),
                                    device="cpu")
    assert int(st.num_active) == 300 and cfg.max_occupancy == 3


def test_headless_chrometrace(small_runs):
    d = small_runs["port"][0]
    with open(os.path.join(d, "benchmark.json")) as f:
        trace = json.load(f)
    names = [e["name"] for e in trace["traceEvents"]]
    assert names.count("run") == 1
    assert [n for n in names if n.startswith("frame ")] == [
        f"frame {i}" for i in range(8)]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in trace["traceEvents"])


def test_headless_around_run_brackets_the_step_loop(tmp_path):
    """``main(argv, around_run=...)``: the hook gets the built engine, and
    its context holds every step and no end-of-run work (the checkpoint
    is written after it closes)."""
    ckpt = str(tmp_path / "end.npz")
    seen = []

    @contextlib.contextmanager
    def around_run(eng):
        step = eng.step

        def counted():
            seen.append("step")
            return step()
        eng.step = counted
        seen.append(("enter", eng.num_particles()))
        yield
        seen.append(("exit", os.path.exists(ckpt)))

    summary, _ = _quiet(lambda: headless.main(
        ["--particles", "40", "--steps", "3", "--world", "32", "32",
         "--sort-interval", "0", "--solver", "jacobi", "--set",
         "max_occupancy=3", "--checkpoint", ckpt, "--device", "cpu"],
        around_run=around_run))
    assert seen == [("enter", 40), "step", "step", "step", ("exit", False)]
    assert os.path.exists(ckpt) and summary["steps"] == 3


def _tiled_scene(n=300, seed=21):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1.0, 47.0, (n, 2)).astype(np.float32)
    prev = (pos + rng.normal(0.0, 0.05, pos.shape)).astype(np.float32)
    return pos, np.full(n, 0.5, np.float32), prev


def _resume_argv(ckpt, out):
    return ["--resume", ckpt, "--steps", "8", "--attract", "2", "24", "20",
            "--release", "6", "--set", "tiled_collide=jnp",
            "--set", "tiled_relocate=jnp", "--checkpoint", out,
            "--summary-json"]


def test_resume_jax_tiled_checkpoint_in_both_clis(tmp_path):
    """The whole slice through the CLIs: a JAX tiled checkpoint resumed by
    both, 8 steps with the attractor, the end checkpoints compared."""
    cfg = JConfig(max_particles=400, initial_particles=300,
                  world_width=48.0, world_height=48.0, pipeline="tiled",
                  tile_cap=4, sort_interval_steps=0)
    pos, rad, prev = _tiled_scene()
    ckpt = str(tmp_path / "start.npz")
    JEngine.from_arrays(cfg, pos, rad, previous_positions=prev
                        ).save_checkpoint(ckpt)
    got, _ = _quiet(headless.main, _resume_argv(ckpt, str(tmp_path / "t.npz"))
                    + ["--device", "cpu"])
    want, _ = _quiet(jheadless.main, _resume_argv(ckpt,
                                                  str(tmp_path / "j.npz")))
    assert got["particles"] == want["particles"] == 300
    assert got["overflow_count"] == want["overflow_count"]
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        np.testing.assert_array_equal(t["pid"], j["pid"])
        np.testing.assert_array_equal(t["overflow"], j["overflow"])
        for f in ("positions", "previous_positions", "radii"):
            np.testing.assert_allclose(t[f], j[f], atol=1e-4, rtol=0,
                                       err_msg=f)
        assert not np.allclose(t["positions"], pos[t["pid"]], atol=1e-3)
    # the port's end checkpoint resumes in the port's engine as well
    e = TEngine.from_checkpoint(str(tmp_path / "t.npz"), device="cpu")
    assert e.num_particles() == 300 and e.config.tiled_collide == "jnp"


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_profiler_chrometrace_format(tmp_path):
    events = {}
    for name, prof in (("port", profiling.Profiler()),
                       ("jax", jprof.Profiler())):
        synced = []
        with prof.scope("outer"):
            with prof.scope("inner", sync=lambda: synced.append(1)):
                sum(range(1000))
        path = str(tmp_path / f"{name}.json")
        assert prof.export_chrometrace(path) == path
        with open(path) as f:
            trace = json.load(f)
        assert synced == [1] and trace["displayTimeUnit"] == "ms"
        events[name] = trace["traceEvents"]
    for a, b in zip(events["port"], events["jax"]):
        assert sorted(a) == sorted(b) and a["name"] == b["name"]
    assert [e["name"] for e in events["port"]] == ["inner", "outer"]
    for e in events["port"]:
        assert e["ph"] == "X" and e["dur"] >= 0 and e["ts"] >= 0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)) as d:
        torch.ones(8).sum()
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def _array_cfg(mod):
    return mod(max_particles=512, initial_particles=256, world_width=64.0,
               world_height=64.0, initial_radius=0.5, sort_interval_steps=0,
               max_occupancy=3)


def _jax_names(breakdown, config, state, params):
    """The phase names a JAX breakdown reports, with its jit replaced by a
    stub whose programs return a pair of zeros (each phase's output is
    drained, or unpacked into a pair): the names only, no compile."""
    zeros = jax.numpy.zeros((1,), jax.numpy.float32)
    stub = types.SimpleNamespace(jit=lambda f, **kw: (lambda *a: (zeros,
                                                                  zeros)),
                                 tree_util=jax.tree_util)
    with mock.patch.object(jprof, "jax", stub):
        return list(breakdown(config, state, params, repeats=1))


@pytest.mark.parametrize("pipeline", ["sorted", "bucket"])
def test_phase_breakdown_names_every_jax_phase(pipeline):
    jcfg = _array_cfg(JConfig).replace(pipeline=pipeline)
    je = JArrayEngine(jcfg, seed=0)
    want = _jax_names(jprof.phase_breakdown, jcfg, je.state, je.params())
    tcfg = _array_cfg(TConfig).replace(pipeline=pipeline, sort_impl="radix")
    te = make_engine(tcfg, device="cpu")
    te.run(2)
    got = profiling.phase_breakdown(tcfg, te.state, te.params(), repeats=1)
    assert list(got) == want
    assert ("sort_map" in got) == (pipeline == "sorted")
    assert all(np.isfinite(v) and v >= 0 for v in got.values())


@pytest.mark.parametrize("solver", ["jacobi", "gs"])
def test_tiled_phase_breakdown_names_every_jax_phase(solver):
    kw = dict(max_particles=300, initial_particles=300, world_width=40.0,
              world_height=30.0, pipeline="tiled", tile_cap=4,
              tiled_uniform_radius=True)
    if solver == "gs":
        kw.update(tiled_solver="gs", tile_multiplier=2.2, max_occupancy=3)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    pos, rad, prev = _tiled_scene(300, 5)
    pos = np.clip(pos, 0.6, [39.4, 29.4]).astype(np.float32)
    je = JEngine.from_arrays(jcfg, pos, rad, previous_positions=prev)
    te = TEngine.from_arrays(tcfg, pos, rad, previous_positions=prev,
                             device="cpu")
    want = _jax_names(functools.partial(jprof.tiled_phase_breakdown,
                                        errors={}),
                      jcfg, je.state, je.params())
    got = profiling.tiled_phase_breakdown(tcfg, te.state, te.params(),
                                          repeats=1)
    assert list(got) == [n.replace("pallas", "cuda") for n in want]
    assert any("gs_solve" in n for n in got) == (solver == "gs")
    assert all(np.isfinite(v) and v >= 0 for v in got.values())


def test_tiled_phase_breakdown_raises_on_a_failing_phase(monkeypatch):
    """No NaN: a phase whose kernel fails raises."""
    from gpu_physics_engine_torch.ops import tiled_kernels as tk
    e = TEngine(TConfig(max_particles=64, initial_particles=64,
                        world_width=16.0, world_height=16.0,
                        pipeline="tiled", tile_cap=4), device="cpu")

    def broken(*a, **kw):
        raise RuntimeError("K3 launch failed")
    monkeypatch.setattr(tk, "collide", broken)
    with pytest.raises(RuntimeError, match="K3 launch failed"):
        profiling.tiled_phase_breakdown(e.config, e.state, e.params(),
                                        repeats=1)


# ---------------------------------------------------------------------------
# input
# ---------------------------------------------------------------------------

class _Recorder:
    """An engine that records the calls InputManager makes."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name not in ("spawn_at", "move_mouse", "press_mouse",
                        "release_mouse"):
            raise AttributeError(name)
        return lambda *a: self.calls.append(
            (name, *[tuple(map(float, v)) for v in a]))


SCRIPT = [("move", (160.0, 120.0)), ("key", "p", True), ("key", "g", True),
          ("button", "left", True), ("move", (20.0, 33.5)),
          ("button", "right", True), ("button", "left", False),
          ("key", "D", True), ("key", "ArrowUp", True), ("wheel", 2.0),
          ("key", "d", False), ("move", (300.0, 10.0)), ("key", "p", True),
          ("key", "p", False), ("key", "x", True), ("key", "Escape", True)]


def _drive_input(im_mod, viewer_mod):
    eng, quits = _Recorder(), []
    v = viewer_mod((64.0, 64.0), (320, 240))
    im = im_mod.InputManager(eng, v, on_quit=lambda: quits.append(1))
    for ev in SCRIPT:
        if ev[0] == "move":
            im.process_cursor_moved(ev[1])
        elif ev[0] == "key":
            im.process_keyboard_input(ev[1], ev[2])
        elif ev[0] == "button":
            im.process_mouse_input(ev[1], ev[2])
        else:
            im.process_mouse_wheel(ev[1])
        v.camera.update(1 / 60)
    return eng.calls, quits, v.draw_grid, dict(v.camera.pressed), \
        v.camera.zoom, tuple(v.camera.position)


def test_input_manager_makes_jax_calls():
    got = _drive_input(tinput, Viewer)
    want = _drive_input(jinput, JViewer)
    assert got[0] == want[0]
    assert [c[0] for c in got[0]].count("spawn_at") == 2
    assert got[1:] == want[1:]
    assert got[1] == [1] and got[2] is True


# ---------------------------------------------------------------------------
# the window app, and the web app (tests/test_web.py's checks; last: its
# simulation thread runs until the module ends)
# ---------------------------------------------------------------------------

def test_window_app_three_frames_under_agg():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    from gpu_physics_engine_torch.app import interactive
    n, _ = _quiet(interactive.main, [
        "--frames", "3", "--particles", "200", "--world", "64", "64",
        "--window", "160", "120", "--pipeline", "tiled",
        "--preview-scale", "2", "--set", "tile_cap=4",
        "--set", "sort_interval_steps=0", "--device", "cpu"])
    assert n == 3



@pytest.fixture(scope="module")
def served_app():
    cfg = TConfig(max_particles=700, initial_particles=512,
                  world_width=64.0, world_height=32.0, max_occupancy=3)
    eng = make_engine(cfg, seed=0, device="cpu")
    app = WebApp(eng, Viewer((cfg.world_width, cfg.world_height), (160, 80)))
    app.start()
    srv = make_server(app, port=0, screen=(160, 80))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield app, srv.server_address[1]
    app.stop()
    srv.shutdown()
    srv.server_close()
    app.join(timeout=60)
    th.join(timeout=60)
    assert not th.is_alive()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path, body)
    r = conn.getresponse()
    out = r.status, r.read()
    conn.close()
    return out


def _wait(cond, seconds=60):
    deadline = time.time() + seconds
    while time.time() < deadline and not cond():
        time.sleep(0.1)
    return cond()


def test_web_page_and_stats(served_app):
    _, port = served_app
    status, body = _request(port, "GET", "/")
    assert status == 200 and b"<canvas" in body
    status, body = _request(port, "GET", "/stats")
    assert status == 200 and json.loads(body)["particles"] == 512
    assert _request(port, "GET", "/nope")[0] == 404


def test_web_frame_stream_is_png_and_sim_advances(served_app):
    app, port = served_app
    assert _wait(lambda: _request(port, "GET", "/frame.png")[0] == 200), \
        "no frame within the deadline"
    status, body = _request(port, "GET", "/frame.png")
    assert status == 200 and body.startswith(b"\x89PNG\r\n\x1a\n")
    f0 = app.stats()["frame"]
    assert _wait(lambda: app.stats()["frame"] > f0), \
        "the simulation thread is not advancing"


def test_web_input_events_reach_engine(served_app):
    app, port = served_app

    def post(ev):
        return _request(port, "POST", "/event", json.dumps(ev))[0]
    assert post({"type": "move", "x": 80, "y": 40}) == 200
    assert post({"type": "button", "pressed": True}) == 200
    assert _wait(lambda: app.engine.mouse_pressed), "press never applied"
    np.testing.assert_allclose(app.engine.mouse_pos, (32.0, 16.0), atol=1e-6)
    z0 = float(app.viewer.camera.zoom)
    post({"type": "wheel", "delta": 1.0})
    assert _wait(lambda: float(app.viewer.camera.zoom) != z0)
    n0 = app.stats()["particles"]
    post({"type": "key", "key": "p", "pressed": True})
    assert _wait(lambda: app.stats()["particles"] == n0 + 100)
    post({"type": "button", "pressed": False})
    assert _wait(lambda: not app.engine.mouse_pressed)
    assert _request(port, "POST", "/event", "not json")[0] == 400
