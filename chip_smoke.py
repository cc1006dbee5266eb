#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpu_physics_engine_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build: the CUDA kernels from csrc/ (nvcc, sm_90a), with the time;
  3. kernel vs plain on the card: K1 (fused collide + integrate) for the
     uniform and the general radius, mouse pressed, at a small shape and
     at the 4M-particle shape, within 1e-5 with pid equal; K2 (pull
     relocate) for flip / flip2 / greedy, hysteresis on and off, cap 4 and
     cap 8, all six fields and the deferral counts bit-equal; every kernel
     run twice gives bit-equal outputs;
  4. main path at 4,194,304 particles: make_tuned_engine on the card, 150
     steps free then 150 with the mouse pressed (crossing the claim-relocate
     sweep at step 240); the launch counters show K1 on every step and K2
     on every relocating step; every pid survives; positions are finite and
     inside the world; ms/step from CUDA events and the quality counters;
  5. the rebuild-sweep path at 256,000 particles: 250 steps, same checks;
  6. kernel times at the 4M shapes against their plain versions.

Then a line {"kernels": [...]} and, last, the result line
{"ok": true, "device": {...}}.  Without a CUDA device (or without the
package beside this script) it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
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


def phase_environment() -> None:
    import torch
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = "not found"
    if CUDA_HOME:
        out = subprocess.run([f"{CUDA_HOME}/bin/nvcc", "--version"],
                             capture_output=True, text=True)
        nvcc = out.stdout.strip().splitlines()[-1] if out.stdout else nvcc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc: {nvcc}")
    log(smi.splitlines()[0])


def phase_build() -> None:
    from gpu_physics_engine_torch.ops import _cuda
    info = _cuda.build()
    _cuda.library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"[build] {info['path'].split('/')[-1]} in {info['seconds']:.1f} s")
    for ln in ptxas:
        log(f"[build] {ln}")


def _jittered(state, scale, seed):
    """``state`` with live x/y displaced by up to +-scale (on the card)."""
    import torch
    g = torch.Generator(device=state.device).manual_seed(seed)
    occ = state.pid >= 0
    dx = (torch.rand(state.x.shape, generator=g, device=state.device)
          - 0.5) * 2 * scale
    dy = (torch.rand(state.x.shape, generator=g, device=state.device)
          - 0.5) * 2 * scale
    return state.replace(x=torch.where(occ, state.x + dx, state.x),
                         y=torch.where(occ, state.y + dy, state.y))


def _small_state(cap, uniform=True):
    import numpy as np
    from gpu_physics_engine_torch import SimConfig
    from gpu_physics_engine_torch.ops import tiled
    cfg = SimConfig(max_particles=3000, initial_particles=3000,
                    world_width=96.0, world_height=60.0, pipeline="tiled",
                    tile_cap=cap, tiled_uniform_radius=uniform)
    rng = np.random.default_rng(cap)
    pos = np.stack([rng.uniform(0.6, 95.4, 3000),
                    rng.uniform(0.6, 59.4, 3000)], -1).astype(np.float32)
    rad = (np.full(3000, 0.5, np.float32) if uniform
           else rng.uniform(0.3, 0.5, 3000).astype(np.float32))
    prev = (pos + rng.normal(0, 0.05, pos.shape)).astype(np.float32)
    return cfg, tiled.init_tiles(cfg, pos, rad, previous_positions=prev,
                                 device="cuda")


def phase_kernels(big_cfg, big_state) -> dict:
    """Kernel vs plain on the card; returns the max errors."""
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    errs = {"collide_integrate": 0.0, "relocate_pull": 0.0}
    small_cfg, small_uniform = _small_state(4, uniform=True)
    _, small_mixed = _small_state(4, uniform=False)
    # (label, config, state for the uniform variant, for the general one);
    # the general variant reads the radius plane (mixed radii when small)
    shapes = [("small", small_cfg, small_uniform, small_mixed),
              ("4M", big_cfg, big_state, big_state)]
    for label, cfg, st, st_general in shapes:
        prm = StepParams.make(cfg.dt, mouse=(0.5 * cfg.world_width,
                                             0.5 * cfg.world_height),
                              pressed=True).as_tensor("cuda")
        for uniform, s in ((True, st), (False, st_general)):
            c = cfg.replace(tiled_uniform_radius=uniform)
            a = tk.collide_integrate_cuda(s, prm, c)
            a2 = tk.collide_integrate_cuda(s, prm, c)
            b = tk.collide_integrate_plain(s, prm, c)
            torch.cuda.synchronize()
            err = max(float((getattr(a, f) - getattr(b, f)).abs().max())
                      for f in ("x", "y", "px", "py"))
            same = all(torch.equal(getattr(a, f), getattr(a2, f))
                       for f in ("x", "y", "px", "py"))
            if not (err <= 1e-5 and same and torch.equal(a.pid, b.pid)):
                raise AssertionError(f"K1 {label} uniform={uniform}: "
                                     f"max err {err}, repeat-equal {same}")
            errs["collide_integrate"] = max(errs["collide_integrate"], err)
            log(f"[k1] {label} {list(s.dims)} uniform={uniform}: "
                f"max_abs_err {err:.3g}, repeat bit-equal")
        # K2: every matching mode, hysteresis off and auto
        moved = _jittered(st, 0.6 * tiled.tile_geometry(cfg)[0], seed=1)
        for match in ("flip", "flip2", "greedy"):
            for hyst in (0.0, -1.0):
                c = cfg.replace(tiled_match=match, tiled_hysteresis=hyst)
                a, da = tk.relocate_pull_cuda(moved, c)
                a2, da2 = tk.relocate_pull_cuda(moved, c)
                b, db = tk.relocate_pull_plain(moved, c)
                torch.cuda.synchronize()
                eq = all(torch.equal(getattr(a, f), getattr(b, f))
                         for f in tiled.FIELDS) and torch.equal(da, db)
                err = max(float((getattr(a, f) - getattr(b, f)).abs().max())
                          for f in ("x", "y", "px", "py", "radius"))
                errs["relocate_pull"] = max(errs["relocate_pull"], err)
                rep = all(torch.equal(getattr(a, f), getattr(a2, f))
                          for f in tiled.FIELDS) and torch.equal(da, da2)
                if not (eq and rep):
                    raise AssertionError(f"K2 {label} {match} hyst={hyst}: "
                                         f"bit-equal {eq}, repeat {rep}")
                n_live = int((a.pid >= 0).sum())
                if n_live != int((moved.pid >= 0).sum()):
                    raise AssertionError(f"K2 {label} {match}: lost pids")
                log(f"[k2] {label} cap {c.tile_cap} {match} "
                    f"hysteresis={c.hysteresis_delta:.3g}: bit-equal, "
                    f"repeat bit-equal, deferred {int(da.sum())} of "
                    f"{n_live}")
    return errs


def _check_engine(e, n, label) -> dict:
    import numpy as np
    from gpu_physics_engine_torch.ops import tiled
    pid, pos, _, rad = tiled.export_particles(e.state)
    if not np.array_equal(pid, np.arange(n)):
        raise AssertionError(f"{label}: pid set is not arange({n}) "
                             f"({len(pid)} live)")
    cfg = e.config
    if not np.isfinite(pos).all():
        raise AssertionError(f"{label}: non-finite positions")
    inside = ((pos[:, 0] >= rad - 1e-4)
              & (pos[:, 0] <= cfg.world_width - rad + 1e-4)
              & (pos[:, 1] >= rad - 1e-4)
              & (pos[:, 1] <= cfg.world_height - rad + 1e-4))
    if not inside.all():
        raise AssertionError(f"{label}: {int((~inside).sum())} particles "
                             "outside [r, W-r] x [r, H-r]")
    speed = np.linalg.norm(e.velocities(), axis=1)
    return {"stale_pct": float(tiled.stale_pair_fraction(e.state, cfg))
            * 100.0, "speed_mean": float(speed.mean()),
            "speed_p99": float(np.percentile(speed, 99)),
            "tile": tiled.tile_geometry(cfg)[0]}


def phase_engine(n, windows, label, expect_k1, expect_k2) -> dict:
    """Drive make_tuned_engine(n) on the card through ``windows`` =
    [(steps, mouse or None)]; check counters, conservation and bounds."""
    import torch
    from gpu_physics_engine_torch import make_tuned_engine
    from gpu_physics_engine_torch.core.tuned import QUALITY_EXPECTATION
    from gpu_physics_engine_torch.ops import tiled_kernels as tk
    t0 = time.perf_counter()
    e = make_tuned_engine(n, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = e.config
    if e.num_particles() != n or int(e.state.overflow_count) != 0:
        raise AssertionError(f"{label}: init placed {e.num_particles()}")
    of0 = int(e.state.overflow_count)
    win_ms = []
    tk.reset_launches()
    for steps, mouse in windows:
        if mouse is not None:
            e.press_mouse(mouse)
        t = cuda_ms(lambda: e.run(steps), reps=1, warmup=0) / steps
        win_ms.append(t)
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    if (launches["collide_integrate"] != expect_k1
            or launches["relocate_pull"] != expect_k2):
        raise AssertionError(f"{label}: launches {launches}, expected K1 "
                             f"{expect_k1}, K2 {expect_k2}")
    steps_total = sum(s for s, _ in windows)
    deferred = int(e.state.overflow_count) - of0
    q = _check_engine(e, n, label)
    # 32 more steps as they come after the windows (mouse still held)
    steady = cuda_ms(lambda: e.run(32), reps=1, warmup=0) / 32
    dpp = deferred / steps_total / n * 100.0
    exp = QUALITY_EXPECTATION.get(n)
    log(f"[{label}] geometry cap {cfg.tile_cap} x {list(e.state.dims[1:])} "
        f"match {cfg.tiled_match} interval {cfg.tiled_relocate_interval} "
        f"sweep {cfg.tiled_sweep}; init {init_s:.1f} s")
    log(f"[{label}] launches {launches} over {steps_total} steps; all "
        f"{n} pids present, finite, inside the world")
    log(f"[{label}] ms/step (CUDA events) windows "
        f"{[round(w, 4) for w in win_ms]} (sweeps included), next 32 "
        f"steps {steady:.4f}")
    log(f"[{label}] stale {q['stale_pct']:.4f}%  deferred "
        f"{dpp:.4f}%/step (population {dpp * cfg.tiled_relocate_interval:.4f}"
        f"%)  watchdog events {e.watchdog_events}  expectation (deferred "
        f"population %, stale %) <= {exp}; speed mean {q['speed_mean']:.3f}"
        f" p99 {q['speed_p99']:.3f} per step (tile edge {q['tile']:.3f})")
    return {"launches": launches, "steady_ms": steady, "win_ms": win_ms,
            "engine": e}


def phase_times(cfg, state) -> dict:
    """K1 and K2 against their plain versions at the 4M shapes."""
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    prm = StepParams.make(cfg.dt).as_tensor("cuda")
    moved = _jittered(state, 0.3 * tiled.tile_geometry(cfg)[0], seed=2)
    out = {}
    runs = {
        "collide_integrate": (lambda: tk.collide_integrate_cuda(state, prm,
                                                                cfg),
                              lambda: tk.collide_integrate_plain(state, prm,
                                                                 cfg)),
        "relocate_pull": (lambda: tk.relocate_pull_cuda(moved, cfg),
                          lambda: tk.relocate_pull_plain(moved, cfg)),
    }
    for name, (kern, plain) in runs.items():
        p1 = cuda_ms(plain, reps=2)
        k1 = cuda_ms(kern, reps=20)
        k2 = cuda_ms(kern, reps=20)
        p2 = cuda_ms(plain, reps=2)
        out[name] = (min(k1, k2), min(p1, p2))
        log(f"[time] {name} {list(state.dims)}: kernel {k1:.4f} / "
            f"{k2:.4f} ms, plain {p1:.3f} / {p2:.3f} ms")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import gpu_physics_engine_torch  # noqa: F401  (fails outside the repo)
    from gpu_physics_engine_torch import make_tuned_engine

    phase_environment()
    phase_build()

    big = make_tuned_engine(4_194_304, device="cuda")
    big_cfg, big_state = big.config, big.state
    rng_prev = _jittered(big_state, 0.05, seed=3)  # some velocity
    big_state = big_state.replace(px=rng_prev.x, py=rng_prev.y)
    del big
    errs = phase_kernels(big_cfg, big_state)

    main_run = phase_engine(4_194_304, [(150, None), (150, (1524.0, 524.0))],
                            "4M", expect_k1=300, expect_k2=150)
    del main_run["engine"]
    torch.cuda.empty_cache()
    phase_engine(256_000, [(250, None)], "256k", expect_k1=250,
                 expect_k2=125)

    times = phase_times(big_cfg, big_state)
    kernels = []
    for name, line in (("collide_integrate", 524), ("relocate_pull", 945)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gpu_physics_engine_torch/csrc/tiled_kernels.cuh",
            "replaces": f"gpu_physics_engine_tpu/ops/tiled_pallas.py:{line}",
            "launches": main_run["launches"][name],
            "max_abs_err": errs[name],
            "ms": times[name][0], "plain_ms": times[name][1]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
