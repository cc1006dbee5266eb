"""Headless scripted runs (``gpu_physics_engine_tpu.app.headless``): the
BASELINE.json configurations as a CLI.

The analog of running the reference app without a window: the frame loop
of State::update (state.rs:115-134) without the render pass, plus optional
frames through the host viewer.  It runs on the CUDA card unless given
``--device cpu``; without a card it raises.  Examples:

  # a named scene (scenes.py): tiny, interactive, million, four_million,
  # sixteen_million
  python -m gpu_physics_engine_torch.app.headless --scene four_million \\
      --tilemap --render-every 50 --summary-json

  # 100k with gravity, the scripted attractor and a spawn burst
  python -m gpu_physics_engine_torch.app.headless --particles 100000 \\
      --steps 600 --gravity 0 -98 --attract 300 1524 524 --spawn 200 1524 524

  # a small run on the CPU with a chrome trace of its scopes
  python -m gpu_physics_engine_torch.app.headless --device cpu \\
      --particles 2000 --world 96 48 --steps 50 --chrometrace trace.json

Prints the FrameTimer summary at exit (render_timer.rs:32-38) and, with
``--summary-json``, one JSON line with the JAX package's keys.  The loop
calls ``step()`` once a step without waiting for the device, so
``avg_ms_per_step`` and ``fps`` are the host's enqueue rate, not device
time; to time the device, pass ``main`` an ``around_run`` that brackets
the step loop with CUDA events (chip_smoke.py does).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os

import numpy as np

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.core.tiled_engine import default_device
from gpu_physics_engine_torch.utils.profiling import Profiler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Headless particle simulation run")
    p.add_argument("--scene", type=str, default="",
                   help="run a named BASELINE scene preset (see scenes.py); "
                        "overrides --particles/--world/--gravity/event flags")
    p.add_argument("--particles", type=int, default=1_000_000)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--substeps", type=int, default=1)
    p.add_argument("--world", type=float, nargs=2, default=(3048.0, 1048.0))
    p.add_argument("--gravity", type=float, nargs=2, default=(0.0, 0.0))
    p.add_argument("--dt", type=float, default=1.0 / 60.0)
    p.add_argument("--sort-interval", type=int, default=240,
                   help="Morton resort cadence in steps (4 s at 60 fps)")
    p.add_argument("--solver", choices=("colored", "fast", "jacobi"),
                   default="colored")
    p.add_argument("--pipeline", choices=("sorted", "bucket", "tiled"),
                   default="sorted")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--attract", type=float, nargs=3, metavar=("STEP", "X", "Y"),
                   action="append", default=[],
                   help="press the mouse attractor at STEP at world (X, Y)")
    p.add_argument("--release", type=int, action="append", default=[],
                   metavar="STEP", help="release the attractor at STEP")
    p.add_argument("--spawn", type=float, nargs=3, metavar=("STEP", "X", "Y"),
                   action="append", default=[],
                   help="spawn a 100-burst at STEP at world (X, Y)")
    p.add_argument("--render-every", type=int, default=0,
                   help="save a PNG frame every N steps")
    p.add_argument("--tilemap", action="store_true",
                   help="render the tile density/velocity map aggregated "
                        "on the device instead of per-particle frames "
                        "(tiled pipeline only)")
    p.add_argument("--out", type=str, default="frames")
    p.add_argument("--checkpoint", type=str, default="",
                   help="save a checkpoint at the end")
    p.add_argument("--resume", type=str, default="",
                   help="resume from a checkpoint (ignores --particles)")
    p.add_argument("--chrometrace", type=str, default="",
                   help="export the run's scopes as chrome://tracing JSON")
    p.add_argument("--summary-json", action="store_true",
                   help="print a machine-readable summary line")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   dest="overrides",
                   help="override any SimConfig field by name (repeatable), "
                        "e.g. --set tile_cap=6 --set tile_multiplier=3.3 "
                        "--set tiled_relocate_interval=2 --set gs_layout=mx; "
                        "values are coerced to the field's type")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the engine (default cuda: raises "
                        "without a card; cpu runs the kernels' plain "
                        "versions)")
    return p


def apply_overrides(cfg: SimConfig, overrides) -> SimConfig:
    """--set K=V handling: coerce V to the dataclass field's type (bool
    accepts 0/1/true/false; floats/ints parsed; strings passed through)
    and replace.  Unknown fields raise with the list of valid names."""
    fields = {f.name: f for f in dataclasses.fields(SimConfig)}
    kw = {}
    for item in overrides:
        key, sep, val = item.partition("=")
        if not sep:
            raise SystemExit(f"--set expects K=V, got {item!r}")
        if key not in fields:
            raise SystemExit(f"--set: unknown SimConfig field {key!r} "
                             f"(valid: {', '.join(sorted(fields))})")
        current = getattr(cfg, key)
        if isinstance(current, bool):
            kw[key] = val.lower() in ("1", "true", "yes", "on")
        elif isinstance(current, int):
            kw[key] = int(val)
        elif isinstance(current, float):
            kw[key] = float(val)
        elif isinstance(current, tuple):
            kw[key] = tuple(float(v) for v in val.split(","))
        elif current is None:
            # Optional fields (e.g. tile_max_radius: float | None) carry no
            # runtime type: parse by value, none/int/float/str
            if val.lower() in ("none", "null"):
                kw[key] = None
            else:
                for cast in (int, float):
                    try:
                        kw[key] = cast(val)
                        break
                    except ValueError:
                        pass
                else:
                    kw[key] = val
        else:
            kw[key] = val
    return cfg.replace(**kw) if kw else cfg


def _build_engine(args, device):
    """The engine the arguments name; sets ``args.pipeline`` (and, for a
    scene, the steps and the event flags) from it."""
    from gpu_physics_engine_torch import Engine, make_engine
    if args.scene:
        from gpu_physics_engine_torch.scenes import get_scene
        scene = get_scene(args.scene)
        args.steps = scene.steps
        args.attract = [(e.step, *e.pos) for e in scene.events
                        if e.kind == "press"]
        args.release = [e.step for e in scene.events if e.kind == "release"]
        args.spawn = [(e.step, *e.pos) for e in scene.events
                      if e.kind == "spawn"]
        cfg = apply_overrides(scene.config, args.overrides)
        args.pipeline = cfg.pipeline
        return make_engine(cfg, seed=args.seed, device=device)
    if args.resume:
        with np.load(args.resume) as z:
            is_tiled = "__kind__" in z.files
        if is_tiled:
            from gpu_physics_engine_torch.core.tiled_engine import TiledEngine
            from gpu_physics_engine_torch.utils.checkpoint import (
                peek_tiled_config)
            # from_checkpoint re-tiles under the merged config (geometry
            # overrides are safe) and restores any big-particle overlay
            args.pipeline = "tiled"
            return TiledEngine.from_checkpoint(
                args.resume, seed=args.seed, device=device,
                config=apply_overrides(peek_tiled_config(args.resume),
                                       args.overrides))
        from gpu_physics_engine_torch.utils.checkpoint import load_checkpoint
        state, cfg = load_checkpoint(args.resume, device=device)
        cfg = apply_overrides(cfg, args.overrides)
        args.pipeline = cfg.pipeline
        return Engine(cfg, seed=args.seed, initial_state=state)
    cfg = SimConfig(
        max_particles=args.particles + 100 * len(args.spawn),
        initial_particles=args.particles,
        world_width=args.world[0], world_height=args.world[1],
        gravity=tuple(args.gravity), dt=args.dt,
        substeps=args.substeps,
        sort_interval_steps=args.sort_interval,
        solver=args.solver, pipeline=args.pipeline)
    cfg = apply_overrides(cfg, args.overrides)
    args.pipeline = cfg.pipeline
    return make_engine(cfg, seed=args.seed, device=device)


def main(argv=None, around_run=None) -> dict:
    """Run the CLI on ``argv``; returns the summary dict.  ``around_run``,
    if given, is called with the built engine, and the context manager it
    returns is entered around the step loop (the frames written between
    steps inside it; the end-of-run sync, checkpoint and summary
    downloads after it)."""
    args = build_parser().parse_args(argv)
    device = default_device(args.device)
    eng = _build_engine(args, device)

    viewer = None
    if args.render_every:
        os.makedirs(args.out, exist_ok=True)
        if args.tilemap:
            if args.pipeline != "tiled":
                raise SystemExit("--tilemap needs --pipeline tiled")
            viewer = "tilemap"
        else:
            from gpu_physics_engine_torch.render.viewer import Viewer
            viewer = Viewer((eng.config.world_width, eng.config.world_height))

    attract = {int(s): (x, y) for s, x, y in args.attract}
    release = set(args.release)
    spawn = {int(s): (x, y) for s, x, y in args.spawn}

    prof = Profiler()
    bracket = (around_run(eng) if around_run is not None
               else contextlib.nullcontext())
    with bracket, prof.scope("run"):
        for step_i in range(args.steps):
            if step_i in attract:
                eng.press_mouse(attract[step_i])
            if step_i in release:
                eng.release_mouse()
            if step_i in spawn:
                eng.spawn_at(spawn[step_i])
            with prof.scope(f"frame {step_i}"):
                eng.step()
                eng.timer.get_delta()
            if viewer and step_i % args.render_every == 0:
                path = f"{args.out}/frame_{step_i:06d}.png"
                if viewer == "tilemap":
                    from gpu_physics_engine_torch.render.tilemap import (
                        render_tilemap)
                    from gpu_physics_engine_torch.utils.png import write_png
                    write_png(path, render_tilemap(eng.state))
                else:
                    viewer.save_png(path, viewer.render_engine(eng))
    _ = eng.num_particles()  # waits for the device

    if args.checkpoint:
        if args.pipeline == "tiled":
            # the engine's method: it keeps the big-particle overlay
            eng.save_checkpoint(args.checkpoint)
        else:
            from gpu_physics_engine_torch.utils.checkpoint import (
                save_checkpoint)
            save_checkpoint(args.checkpoint, eng.state, eng.config)
    if args.chrometrace:
        prof.export_chrometrace(args.chrometrace)

    summary = {
        "particles": eng.num_particles(),
        "steps": args.steps,
        "avg_ms_per_step": eng.timer.average_ms,
        "fps": eng.timer.fps,
        "overflow_count": int(eng.state.overflow_count),
        "finite": bool(np.isfinite(eng.positions()).all()),
    }
    print(eng.timer.summary())
    if args.summary_json:
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
