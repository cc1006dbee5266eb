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
``--clock-probe N`` runs ``clock_probe`` (N rounds of windows of
``--steps`` steps at pads 0 and ``PAD_S``) in place of ``profile_run``:
how far the profiler's kernel times stray from the host's clock, and how
many records a window keeps.
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

The rest of ``gpu_physics_engine_tpu.utils.profiling``, for the apps:

  * ``Profiler``: host-side named scopes, exported in the chrome://tracing
    JSON format (``export_chrometrace``; the reference's benchmark.json,
    state.rs:108-112).  A scope around an engine call measures the host's
    enqueue unless it is given ``sync=``.
  * ``device_trace``: a torch.profiler trace of a block (CPU ops, and the
    CUDA kernels when a card is visible) as a chrome trace.
  * ``phase_breakdown`` / ``tiled_phase_breakdown``: each stage of the
    array pipeline / the tiled pipeline timed on its own (ms a call: CUDA
    events on the card, the host clock on the CPU).  A stage that fails
    to build or launch raises; no phase is reported as NaN.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional


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


class Profiler:
    """Host-side named scopes and their chrome-trace export."""

    def __init__(self):
        self.events: List[dict] = []
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def scope(self, name: str, sync: Optional[Callable[[], None]] = None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            end = time.perf_counter()
            self.events.append({
                "name": name, "ph": "X", "pid": 0, "tid": 0,
                "ts": (start - self._t0) * 1e6,
                "dur": (end - start) * 1e6,
            })

    def export_chrometrace(self, path: str = "benchmark.json") -> str:
        """Write the scopes in chrome://tracing format (the reference's
        benchmark.json artifact, state.rs:108-112)."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events,
                       "displayTimeUnit": "ms"}, f)
        return path


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A torch.profiler trace of the block: CPU ops, and the CUDA kernels
    when a card is visible; written to ``log_dir``/trace.json (chrome
    trace, for chrome://tracing or Perfetto) when the block ends.  Yields
    ``log_dir`` (default: gpe_torch_trace under the temporary directory)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "gpe_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _phase_ms(fn, device, repeats: int):
    """(ms a call of ``fn``, the output of its warm-up call): CUDA events on
    a card (``cuda_ms``), the host clock on the CPU (where a call is
    synchronous)."""
    import torch
    out = fn()
    if torch.device(device).type == "cuda":
        return cuda_ms(fn, reps=repeats, warmup=0), out
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) / repeats * 1e3, out


def phase_breakdown(config, state, params, repeats: int = 10
                    ) -> Dict[str, float]:
    """ms a call of each stage of the array pipeline on ``state``, each
    stage on its own inputs.  The names are the JAX package's, after the
    reference's profiler scopes (grid.rs:324, collision_cell_builder.rs:
    227, collision_solver.rs:226-229, particle_integration.rs:81):
    "(dispatch overhead)" (a one-element add), "build_cell_ids",
    "sort_map" (the hand radix sort's passes under sort_impl="radix") or
    "build_buckets", "build_collision_cells", "solve_collisions" (the
    colored solve), "particle_integration", "morton_resort"."""
    import torch
    from gpu_physics_engine_torch.core.stepper import cell_size
    from gpu_physics_engine_torch.ops import collision, grid, resort
    from gpu_physics_engine_torch.ops.integrate import f32, verlet_integrate

    dev = state.x.device
    active = state.active_mask()
    cs = cell_size(config, state)
    timings: Dict[str, float] = {}

    def timeit(name, fn):
        timings[name], out = _phase_ms(fn, dev, repeats)
        return out

    one = torch.zeros((), dtype=torch.float32, device=dev)
    timeit("(dispatch overhead)", lambda: one + 1.0)
    cand = timeit("build_cell_ids", lambda: grid.build_candidates(
        state.x, state.y, state.radius, active, cs))
    if config.pipeline == "sorted":
        sc, so = timeit("sort_map", lambda: grid.sort_map(
            *grid.build_cell_ids(cand), impl=config.sort_impl))
        table = timeit("build_collision_cells",
                       lambda: collision.occupants_from_sorted(
                           sc, so, config.max_occupancy))
    else:
        buckets = timeit("build_buckets",
                         lambda: grid.build_buckets(cand, config))
        table = timeit("build_collision_cells",
                       lambda: collision.occupants_from_buckets(buckets,
                                                                config))
    timeit("solve_collisions", lambda: collision.solve_colored(
        state.x, state.y, state.radius, table, f32(config.stiffness)))
    prm = params.as_tensor(dev)
    timeit("particle_integration", lambda: verlet_integrate(
        state.x, state.y, state.px, state.py, state.radius, active, prm,
        config))
    timeit("morton_resort", lambda: resort.morton_resort(
        state, cs, sort_impl=config.sort_impl))
    return timings


def tiled_phase_breakdown(config, state, params, repeats: int = 5
                          ) -> Dict[str, float]:
    """ms a call of each stage of the tiled pipeline on ``state``.  The
    names are the JAX package's with "pallas" replaced by "cuda" where a
    hand kernel runs (on a CPU state those wrappers run their plain
    versions):

      "(dispatch overhead)"         a plane add
      "relocate (claim/jnp)"        ops/tiled.relocate (plain, one sync)
      "relocate (pull/pallas)"  ->  "relocate (pull/cuda)": K2
      "collide (jnp)"               ops/tiled.collide (plain)
      "collide (pallas)"        ->  "collide (cuda)": K3
      "collide+integrate (fused)"   K1
      "particle_integration"        ops/tiled.integrate (plain)
      "gs_solve (pallas, gs_layout=L)" -> "gs_solve (cuda, gs_layout=L)",
                                    tiled_solver="gs" only: the solve in
                                    the configured layout (par on the
                                    card: the relayout, K5-par and K6-par's
                                    color window; flat: K5 and K6)

    Unlike the JAX package's, a phase that fails raises: none is reported
    as NaN."""
    from gpu_physics_engine_torch.ops import gs_parity, tiled
    from gpu_physics_engine_torch.ops import tiled_kernels as tk

    dev = state.device
    prm = params.as_tensor(dev)
    timings: Dict[str, float] = {}

    def timeit(name, fn):
        timings[name] = _phase_ms(fn, dev, repeats)[0]

    timeit("(dispatch overhead)", lambda: state.x + 1.0)
    timeit("relocate (claim/jnp)", lambda: tiled.relocate(state, config))
    timeit("relocate (pull/cuda)", lambda: tk.relocate_pull(state, config))
    timeit("collide (jnp)", lambda: tiled.collide(state, config))
    timeit("collide (cuda)", lambda: tk.collide(state, config))
    timeit("collide+integrate (fused)",
           lambda: tk.collide_integrate(state, prm, config))
    timeit("particle_integration",
           lambda: tiled.integrate(state, params, config, prm=prm))
    if config.tiled_solver == "gs":
        timeit("gs_solve (cuda, gs_layout=%s)" % config.gs_layout,
               lambda: gs_parity.gs_solve_layout(state, config))
    return timings


def _device_us(evt) -> float:
    """Self device time of a key_averages row in microseconds (the
    attribute is named per torch version)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


# seconds that a kernel window keeps its launches clear of each end of the
# profiler's capture window (``kernel_window``)
PAD_S = 0.5


@contextlib.contextmanager
def kernel_window(pad_s: float = PAD_S):
    """torch.profiler over CUDA activity only, around the block, with the
    block's kernels kept ``pad_s`` seconds clear of both ends of the
    capture window: the host sleeps that long after the profiler starts,
    and again after the block's work has synchronised.  The profiler
    drops every kernel record whose timestamp, converted to the host's
    clock, falls outside the capture window, and on the H100's machine
    the converted times stray from the host's clock by milliseconds
    (``clock_probe`` measures it); late in ``chip_smoke.py``'s 15-minute
    run, unpadded windows of 8 steps of 11 ms and of 10 calls of 0.04 ms
    lost every record of their kernels.  Yields the profiler; read it
    after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(pad_s)


def clock_probe(engine, steps: int, windows: int,
                pads=(0.0, PAD_S)) -> List[dict]:
    """How far the profiler's kernel times stray from the host's clock:
    ``windows`` rounds of one ``kernel_window`` per pad of ``pads`` over
    ``engine.run(steps)``, each after 64 unprofiled steps, a copy of the
    positions to the host and a second's sleep.  Per window: the pad, the
    device records kept, the first record's start less the host's time
    just before the first launch, and the last record's end less the
    host's time just after the synchronise (ms).  A negative start means
    that the converted times run early; records converted to before the
    capture window are dropped (fewer records at pad 0)."""
    import torch
    rows = []
    for w in range(windows):
        for pad in pads:
            engine.run(64)
            engine.positions()
            time.sleep(1.0)
            with kernel_window(pad) as prof:
                t0 = time.time_ns()
                engine.run(steps)
                torch.cuda.synchronize()
                t1 = time.time_ns()
            dev = [e for e in prof.profiler.kineto_results.events()
                   if "CUDA" in str(e.device_type())]
            rows.append({
                "window": w, "pad_s": pad, "records": len(dev),
                "first_start_ms": min(((e.start_ns() - t0) / 1e6
                                       for e in dev), default=None),
                "last_end_ms": max(((e.end_ns() - t1) / 1e6 for e in dev),
                                   default=None)})
    return rows


def profile_run(engine, steps: int, trace: str | None = None,
                advance=None, pad_s: float = PAD_S) -> dict:
    """Two passes of ``advance(steps)`` (default ``engine.run``): one
    timed with CUDA events and
    no profiler (its span is the window's device time; the profiler's own
    host overhead would inflate a host-bound window), then one under
    torch.profiler tracing CUDA activity only (``kernel_window`` with
    ``pad_s``), for the device time of each
    kernel.  idle share = 1 - busy / span.  Pick windows that do not cross
    a periodic sweep, so both passes do the same work.  Times in ms."""
    import torch

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

    with torch.cuda.device(engine.device), kernel_window(pad_s) as prof:
        advance(steps)
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
    ap.add_argument("--clock-probe", type=int, default=0,
                    help="after the warm-up, this many rounds of "
                         "clock_probe (--steps a window) in place of "
                         "profile_run")
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
    elif args.clock_probe:
        engine.run(args.warmup)
        out = {"clock_probe": clock_probe(engine, args.steps,
                                          args.clock_probe)}
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
    print(json.dumps(_short(out) if "kernels" in out else out))
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
