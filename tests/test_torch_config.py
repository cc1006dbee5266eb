"""Drift tests for the PyTorch port's copies of the JAX package's config and
tuned tables, and the port's no-jax import rule.

The port copies SimConfig and core/tuned.py instead of importing them,
because the machine that runs it has no jax; these tests hold the copies
equal to the originals, field for field and row for row.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gpu_physics_engine_tpu.core import config as jconfig
from gpu_physics_engine_tpu.core import tuned as jtuned
from gpu_physics_engine_torch.core import config as tconfig
from gpu_physics_engine_torch.core import tuned as ttuned

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "gpu_physics_engine_torch"


def test_simconfig_fields_and_defaults_match():
    jf = dataclasses.fields(jconfig.SimConfig)
    tf = dataclasses.fields(tconfig.SimConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(jf, tf):
        assert str(a.type) == str(b.type), a.name
        assert a.default == b.default, a.name
    assert jconfig.UNUSED_CELL_ID == tconfig.UNUSED_CELL_ID


_CONFIGS = [
    {},
    dict(tile_max_radius=1.5, tile_multiplier=3.3),
    dict(tiled_relocate_interval=4, tiled_drift_budget=0.2),
    dict(tiled_hysteresis=0.1, initial_radius=0.4),
    dict(tiled_hysteresis=0.0, tile_multiplier=2.2),
    dict(max_particles=5000, initial_particles=3000, world_width=64.0,
         world_height=48.0, cell_size_multiplier=3.0),
]


@pytest.mark.parametrize("kw", _CONFIGS)
def test_simconfig_properties_match(kw):
    a = jconfig.SimConfig(**kw)
    b = tconfig.SimConfig(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for name in ("capacity", "tile_max_radius_effective", "min_cell_size",
                 "grid_dims", "num_cells", "drift_budget",
                 "hysteresis_delta"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.cell_size(1.3) == b.cell_size(1.3)
    assert (dataclasses.asdict(a.replace(tile_cap=7))
            == dataclasses.asdict(b.replace(tile_cap=7)))


@pytest.mark.parametrize("kw", [
    dict(initial_particles=10, max_particles=5), dict(solver="x"),
    dict(pipeline="x"), dict(sort_impl="x"), dict(tiled_match="x"),
    dict(tiled_relocate_passes=0), dict(tiled_spawn="x"),
    dict(big_capacity=0), dict(tiled_solver="x"), dict(tiled_sweep="x"),
    dict(tiled_band_rows=1), dict(tiled_rebuild_impl="x"),
    dict(tiled_relocate_interval=0),
    dict(tiled_solver="gs", tiled_relocate_interval=2),
    dict(gs_layout="x"), dict(gs_rank="x"), dict(render_supersample=5),
    dict(world_shape="x"), dict(max_cells_per_object=3),
])
def test_simconfig_checks_match(kw):
    for mod in (jconfig, tconfig):
        with pytest.raises(AssertionError):
            mod.SimConfig(**kw)


def test_tuned_tables_match():
    for name in ("TUNED_NEWTON", "TUNED_TILE_GEOMETRY", "QUALITY_EXPECTATION",
                 "TUNED_OVERRIDES", "_GS_CAP", "GS_FLAGS", "_GS_SWEEP"):
        assert getattr(jtuned, name) == getattr(ttuned, name), name


@pytest.mark.parametrize("n", [1000, 100_000, 180_000, 256_000, 600_000,
                               1_048_576, 4_194_304, 16_000_000])
def test_tuned_functions_match(n):
    assert jtuned.tuned_row(n) == ttuned.tuned_row(n)
    assert jtuned.tuned_chunk(n) == ttuned.tuned_chunk(n)
    assert jtuned.tuned_overrides(n) == ttuned.tuned_overrides(n)
    assert jtuned.GS_TUNED(n) == ttuned.GS_TUNED(n)
    assert jtuned.GS_SWEEP(n) == ttuned.GS_SWEEP(n)
    assert (dataclasses.asdict(jtuned.tuned_config(n, world_width=900.0))
            == dataclasses.asdict(ttuned.tuned_config(n, world_width=900.0)))


@pytest.mark.parametrize("n", [1_048_576, 4_194_304])
def test_gs_config_is_the_bench_recipe(n):
    """gs_config(n) is the configuration bench.py's measure_gs builds."""
    cap, match = jtuned.GS_TUNED(n)
    sweep_iv, sweep_mech = jtuned.GS_SWEEP(n)
    want = jconfig.SimConfig(
        max_particles=n, initial_particles=n, pipeline="tiled",
        tiled_solver="gs", tile_multiplier=2.2, tile_cap=cap,
        max_occupancy=8, tiled_uniform_radius=True, tiled_match=match,
        sort_interval_steps=sweep_iv, tiled_sweep=sweep_mech,
        **jtuned.GS_FLAGS)
    assert dataclasses.asdict(ttuned.gs_config(n)) == dataclasses.asdict(want)
    assert ttuned.gs_config(n, tile_cap=9).tile_cap == 9


def test_port_sources_do_not_import_jax():
    bad = []
    for path in PKG.rglob("*.py"):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if (s.startswith(("import jax", "from jax"))
                    or "gpu_physics_engine_tpu" in s
                    and s.startswith(("import", "from"))):
                bad.append(f"{path.relative_to(REPO)}:{i}: {s}")
    assert not bad, bad


def test_port_imports_and_steps_with_jax_blocked():
    """The machine that runs the port has no jax: the package must import
    and step with ``import jax`` failing."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import gpu_physics_engine_torch as g\n"
        "from gpu_physics_engine_torch.ops import tiled, tiled_kernels, _cuda\n"
        "from gpu_physics_engine_torch.ops import (collision, grid, morton,\n"
        "    radix_sort, resort, scan, sort, spawn)\n"
        "from gpu_physics_engine_torch.core import (engine, state, stepper,\n"
        "    tiled_engine, tuned)\n"
        "from gpu_physics_engine_torch.utils import kernel_study, timer\n"
        "cfg = g.SimConfig(max_particles=64, initial_particles=64,\n"
        "    world_width=16.0, world_height=16.0, pipeline='tiled',\n"
        "    tile_cap=4, sort_interval_steps=3)\n"
        "e = g.make_engine(cfg, seed=1, device='cpu')\n"
        "e.run(4)\n"
        "assert e.num_particles() == 64\n"
        "a = g.make_engine(cfg.replace(pipeline='sorted', sort_impl='radix'),\n"
        "    seed=1, device='cpu')\n"
        "assert isinstance(a, g.Engine)\n"
        "a.run(4)\n"
        "assert a.num_particles() == 64\n"
        "from gpu_physics_engine_torch.ops import gs_mega, gs_parity\n"
        "ge = g.TiledEngine(tuned.gs_config(64, world_width=16.0,\n"
        "    world_height=16.0, tile_cap=4, gs_layout='par',\n"
        "    gs_colors_mega=True, gs_relocate_mega=True), seed=1,\n"
        "    device='cpu')\n"
        "ge.run(3)\n"
        "assert ge.num_particles() == 64\n"
        "from gpu_physics_engine_torch.render import colormap, device\n"
        "img = e.render_frame(width=32, height=16)\n"
        "assert img.shape == (16, 32, 3) and img.max() > 0\n"
        "assert isinstance(ge.render_run(2, width=32, height=16), int)\n"
        "from gpu_physics_engine_torch import scenes\n"
        "from gpu_physics_engine_torch.app import headless, interactive, web\n"
        "from gpu_physics_engine_torch.render import (camera, lines,\n"
        "    rasterizer, tilemap, viewer)\n"
        "from gpu_physics_engine_torch.utils import (device as udev, input,\n"
        "    png, profiling)\n"
        "assert len(scenes.SCENES) == 5 and udev.device_info('cpu')\n"
        "s = headless.main(['--device', 'cpu', '--particles', '64',\n"
        "    '--world', '16', '16', '--steps', '2', '--pipeline', 'tiled',\n"
        "    '--set', 'tile_cap=4'])\n"
        "assert s['particles'] == 64 and s['finite']\n"
        "v = viewer.Viewer((16.0, 16.0), (32, 16))\n"
        "v.toggle_grid()\n"
        "assert v.render_engine(e).shape == (16, 32, 3)\n"
        "assert tilemap.render_tilemap(e.state).max() > 0\n"
        "assert png.encode_png(img).startswith(b'\\x89PNG')\n"
        "assert 'sort_map' in profiling.phase_breakdown(a.config, a.state,\n"
        "    a.params(), repeats=1)\n"
        "from gpu_physics_engine_torch.parallel import (gs_shard, halo,\n"
        "    mesh, tiled_shard)\n"
        "from gpu_physics_engine_torch.app import multichip\n"
        "m = multichip.main(['--device', 'cpu', '--devices', '2',\n"
        "    '--particles', '64', '--world', '16', '16', '--steps', '2',\n"
        "    '--tile-cap', '4'])\n"
        "assert m['particles'] == 64 and m['finite']\n"
        "assert not any(m == 'gpu_physics_engine_tpu' or\n"
        "    m.startswith('gpu_physics_engine_tpu.') for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
