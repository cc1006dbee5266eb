"""Where a step's time goes: a torch.profiler window over an engine's ``run``.

    python -m gpu_physics_engine_torch.utils.profiling --particles 4194304 \\
        --warmup 64 --steps 64 [--gs | --array] [--trace trace.json]

prints one JSON object: the window's span from CUDA events, the device
time per kernel (summed over launches, from a second, profiled window),
the device busy time, the idle share ``1 - busy / span``, the number of
kernel launches, and the device time of the port's hand kernels (the rest
is PyTorch's own kernels).  On a
CPU-only engine the device fields are empty and the idle share is None.
``--gs`` profiles the reference-exact Gauss-Seidel engine
(core/tuned.gs_config) instead of the production Jacobi engine, in the
solve layout ``--layout`` (default "auto"), with ``--mega`` through the
fused kernels (gs_colors_mega and gs_relocate_mega; the par layout).
``--spawn`` first makes that many ``spawn_at`` bursts (spawn_burst
particles each, at points spread across the world), so the Jacobi engine
steps with the big-particle overlay (ops/bigs.py), and adds the overlay's
size and ``couple_bigs`` ms a pass.
``--render`` profiles ``render_run`` (a step and a 1280 x 720 frame)
in place of ``run``, and adds ``render_only``:
the same profile of ``--steps`` frames drawn as ``render_run`` draws them,
with no step (per frame: device ms, launches, the largest PyTorch ops).
``--array`` profiles the array
Engine (core/engine.py) with ``--particles`` in 1.1x as many slots, the
README's default world, and ``--pipeline``, ``--solver`` and
``--sort-impl`` (default sorted, colored, radix); keep warmup + 2 x steps
inside one resort interval (240).

    python -m gpu_physics_engine_torch.utils.profiling --gs \\
        --particles 4194304 --steps 4800 --every 480 \\
        --sweeps relocate rebuild

instead follows the exact periodic sweep over a long horizon
(``sweep_windows``), once per sweep mechanism, and prints one JSON line
per window of ``--every`` steps.
"""

from __future__ import annotations

import argparse
import json
import time


def cuda_ms(fn, reps: int = 20, warmup: int = 1) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls (CUDA
    events around the whole batch, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(evt) -> float:
    """Self device time of a key_averages row in microseconds (the
    attribute is named per torch version)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_run(engine, steps: int, trace: str | None = None,
                advance=None) -> dict:
    """Two passes of ``advance(steps)`` (default ``engine.run``): one
    timed with CUDA events and
    no profiler (its span is the window's device time; the profiler's own
    host overhead would inflate a host-bound window), then one under
    torch.profiler tracing CUDA activity only, for the device time of each
    kernel.  idle share = 1 - busy / span.  Pick windows that do not cross
    a periodic sweep, so both passes do the same work.  Times in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    advance = advance or engine.run
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(engine.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    advance(steps)
    if cuda:
        end.record()
        end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if not cuda:
        return {"steps": steps, "host_wall_ms": wall_ms,
                "device_span_ms": None, "device_busy_ms": None,
                "idle_share": None, "kernels": []}
    span = start.elapsed_time(end)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        advance(steps)
        torch.cuda.synchronize(engine.device)
    if trace:
        prof.export_chrome_trace(trace)
    kernels = sorted(((e.key, _device_us(e) / 1e3, e.count)
                      for e in prof.key_averages() if _device_us(e) > 0),
                     key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kernels)
    return {
        "steps": steps, "host_wall_ms": wall_ms, "device_span_ms": span,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / span,
        "device_launches": sum(n for _, _, n in kernels),
        # the port's hand kernels (namespace gpe); the rest is PyTorch's
        "hand_kernel_ms": sum(ms for k, ms, _ in kernels if "gpe::" in k),
        "kernels": [{"name": k, "ms": ms, "calls": n}
                    for k, ms, n in kernels],
    }


def frames_only(engine):
    """``advance(n)`` drawing n 1280 x 720 frames of the engine's current
    state as ``render_run`` draws them (weights built once; under "par"
    from the parity-space state), with no step."""
    from gpu_physics_engine_torch.ops import gs_parity
    from gpu_physics_engine_torch.render.device import frame_drawer
    draw = frame_drawer(engine.config, 1280, 720, engine.device,
                        parity=engine.parity_space)
    s = (gs_parity.to_parity_state(engine.state, engine.config)
         if engine.parity_space else engine.state)

    def advance(n: int) -> None:
        for _ in range(n):
            draw(s)
    return advance


def _short(out: dict, top: int = 10) -> dict:
    """``out`` with its kernel names cut to 80 characters and only the
    ``top`` largest kept."""
    kernels = [dict(k, name=k["name"].split("(")[0][:80])
               for k in out["kernels"][:top]]
    return {**out, "kernels": kernels}


def sweep_windows(engine, steps: int, every: int, interval: int):
    """Run ``steps`` free steps in windows of ``every`` and yield, per
    window, the step, the stale-pair %, the overflow per step (clamp +
    deferrals), ms/step (host clock after a device sync, sweeps included)
    and each exact sweep's ms (host clock with a device sync on both sides:
    the sweeps synchronise with the host).  The engine's own sweep cadence
    must be off (``sort_interval_steps`` past ``steps``): this drives
    ``engine.sweep()`` itself before every step that is a multiple of
    ``interval``, the engine's schedule.  Turn the watchdog off too: its
    forced sweeps and cap growth would mix a second mechanism into the one
    measured."""
    import torch
    from gpu_physics_engine_torch.ops import tiled

    def sync():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    done = 0
    while done < steps:
        k = min(every, steps - done)
        of0 = int(engine.state.overflow_count)
        sweep_ms, step_end = [], done + k
        sync()
        t0 = time.perf_counter()
        while done < step_end:
            if done and done % interval == 0:
                sync()
                ts = time.perf_counter()
                engine.sweep()
                sync()
                sweep_ms.append((time.perf_counter() - ts) * 1e3)
            span = min(step_end, (done // interval + 1) * interval) - done
            engine.run(span)
            done += span
        sync()
        yield {"step": done,
               "stale_pct": float(tiled.stale_pair_fraction(
                   engine.state, engine.config)) * 100.0,
               "overflow_per_step": (int(engine.state.overflow_count)
                                     - of0) / k,
               "ms_per_step": (time.perf_counter() - t0) * 1e3 / k,
               "sweep_ms": sweep_ms, "num_active": engine.num_particles()}


def main(argv=None) -> dict:
    from gpu_physics_engine_torch import (Engine, SimConfig, TiledEngine,
                                          make_tuned_engine)
    from gpu_physics_engine_torch.core.tuned import gs_config
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=4_194_304)
    ap.add_argument("--warmup", type=int, default=64)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--gs", action="store_true",
                    help="the Gauss-Seidel engine (tiled_solver='gs')")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "flat", "par", "mx", "dec"],
                    help="with --gs: gs_layout")
    ap.add_argument("--mega", action="store_true",
                    help="with --gs: gs_colors_mega and gs_relocate_mega "
                         "(the fused kernels of the par layout)")
    ap.add_argument("--array", action="store_true",
                    help="the array Engine (pipeline sorted/bucket)")
    ap.add_argument("--pipeline", default="sorted",
                    choices=["sorted", "bucket"])
    ap.add_argument("--solver", default="colored",
                    choices=["colored", "jacobi", "fast"])
    ap.add_argument("--sort-impl", default="radix", choices=["lax", "radix"])
    ap.add_argument("--mouse", action="store_true",
                    help="with --array: the mouse held at the world centre")
    ap.add_argument("--spawn", type=int, default=0,
                    help="spawn_at bursts before the warm-up (Jacobi)")
    ap.add_argument("--render", action="store_true",
                    help="profile render_run (a step and a frame) and "
                         "the frames alone")
    ap.add_argument("--device", default=None)
    ap.add_argument("--trace", default=None, help="chrome trace path")
    ap.add_argument("--sweeps", nargs="+", default=None,
                    choices=["relocate", "rebuild", "bands"],
                    help="with --gs: the sweep study, --steps free steps "
                         "per mechanism")
    ap.add_argument("--every", type=int, default=480,
                    help="steps per window of the sweep study")
    args = ap.parse_args(argv)
    if args.sweeps:
        return sweep_study(args)
    if args.array:
        engine = Engine(SimConfig(
            max_particles=args.particles * 11 // 10,
            initial_particles=args.particles, pipeline=args.pipeline,
            solver=args.solver, sort_impl=args.sort_impl),
            device=args.device)
        if args.mouse:
            engine.press_mouse((0.5 * engine.config.world_width,
                                0.5 * engine.config.world_height))
    elif args.gs:
        engine = TiledEngine(gs_config(args.particles,
                                       gs_layout=args.layout,
                                       gs_colors_mega=args.mega,
                                       gs_relocate_mega=args.mega),
                             chunk=64, device=args.device)
    else:
        engine = make_tuned_engine(args.particles, device=args.device)
        cfg = engine.config
        for k in range(args.spawn):
            engine.spawn_at(((k + 1) / (args.spawn + 1) * cfg.world_width,
                             0.5 * cfg.world_height), verbose=False)
    if args.render:
        engine.render_run(args.warmup)
        out = profile_run(engine, args.steps, args.trace,
                          advance=engine.render_run)
        out["render_only"] = _short(profile_run(
            engine, args.steps, advance=frames_only(engine)))
    else:
        engine.run(args.warmup)
        out = profile_run(engine, args.steps, args.trace)
    cfg = engine.config
    out.update(particles=args.particles, device=str(engine.device))
    if getattr(engine, "big", None) is not None:
        from gpu_physics_engine_torch.ops.bigs import couple_bigs
        out.update(bigs=int(engine.big.num_active),
                   big_capacity=engine.big.capacity)
        if engine.device.type == "cuda":
            out["couple_bigs_ms"] = cuda_ms(
                lambda: couple_bigs(engine.state, engine.big, cfg), reps=10)
    if args.array:
        out.update(pipeline=cfg.pipeline, solver=cfg.solver,
                   sort_impl=cfg.sort_impl, mouse=args.mouse)
    else:
        out.update(solver=cfg.tiled_solver, gs_layout=cfg.gs_layout,
                   mega=cfg.gs_colors_mega and cfg.gs_relocate_mega,
                   render=args.render)
    print(json.dumps(_short(out)))
    return out


def sweep_study(args) -> dict:
    """``sweep_windows`` for each of ``args.sweeps`` on the GS engine at
    ``args.particles``, the watchdog off and the GS_SWEEP cadence driven
    by the study; first line: the card's name and power limit."""
    import subprocess
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.core.tuned import GS_SWEEP, gs_config
    if not args.gs:
        raise SystemExit("--sweeps needs --gs")
    if args.device in (None, "cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
    interval = GS_SWEEP(args.particles)[0]
    out = {}
    for sweep in args.sweeps:
        engine = TiledEngine(
            gs_config(args.particles, tiled_sweep=sweep,
                      tiled_watchdog=False,
                      sort_interval_steps=args.steps + 1),
            seed=0, chunk=64, device=args.device)
        out[sweep] = []
        for row in sweep_windows(engine, args.steps, args.every, interval):
            row = {"sweep": sweep, "particles": args.particles, **row}
            print(json.dumps(row), flush=True)
            out[sweep].append(row)
        del engine
    return out


if __name__ == "__main__":
    main()
