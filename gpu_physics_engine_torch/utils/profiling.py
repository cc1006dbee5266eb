"""Where a step's time goes: a torch.profiler window over ``TiledEngine.run``.

    python -m gpu_physics_engine_torch.utils.profiling --particles 4194304 \\
        --warmup 64 --steps 64 [--trace trace.json]

prints one JSON object: the window's span from CUDA events, the device
time per kernel (summed over launches, from a second, profiled window),
the device busy time, and the idle share ``1 - busy / span``.  On a
CPU-only engine the device fields are empty and the idle share is None.
"""

from __future__ import annotations

import argparse
import json
import time


def _device_us(evt) -> float:
    """Self device time of a key_averages row in microseconds (the
    attribute is named per torch version)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_run(engine, steps: int, trace: str | None = None) -> dict:
    """Two passes of ``engine.run(steps)``: one timed with CUDA events and
    no profiler (its span is the window's device time; the profiler's own
    host overhead would inflate a host-bound window), then one under
    torch.profiler tracing CUDA activity only, for the device time of each
    kernel.  idle share = 1 - busy / span.  Pick windows that do not cross
    a periodic sweep, so both passes do the same work.  Times in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(engine.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    engine.run(steps)
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
        engine.run(steps)
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
        "kernels": [{"name": k, "ms": ms, "calls": n}
                    for k, ms, n in kernels],
    }


def main(argv=None) -> dict:
    from gpu_physics_engine_torch import make_tuned_engine
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=4_194_304)
    ap.add_argument("--warmup", type=int, default=64)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--device", default=None)
    ap.add_argument("--trace", default=None, help="chrome trace path")
    args = ap.parse_args(argv)
    engine = make_tuned_engine(args.particles, device=args.device)
    engine.run(args.warmup)
    out = profile_run(engine, args.steps, args.trace)
    out.update(particles=args.particles, device=str(engine.device))
    for k in out["kernels"]:
        k["name"] = k["name"].split("(")[0][:80]
    print(json.dumps({**out, "kernels": out["kernels"][:10]}))
    return out


if __name__ == "__main__":
    main()
