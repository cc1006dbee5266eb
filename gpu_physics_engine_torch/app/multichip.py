"""Sharded headless runner (``gpu_physics_engine_tpu.app.multichip``): the
tiled pipeline cut into tile-row slabs with halo-row exchange
(parallel/tiled_shard.py).

``--devices N`` is the number of slabs (0: one per visible CUDA device).
On ``--device cuda`` (the default) slab i runs on card i mod the number of
visible cards, so N slabs share one card when there is one; ``--device
cpu`` (or an indexed device such as ``cuda:1``) puts every slab there.

  # four slabs on the CPU
  python -m gpu_physics_engine_torch.app.multichip --device cpu \\
      --devices 4 --particles 4096 --world 256 256 --steps 50

  # four slabs on the card(s)
  python -m gpu_physics_engine_torch.app.multichip --devices 4 \\
      --summary-json

Prints one human line and, with ``--summary-json``, one JSON line with
the JAX package's keys.
"""

from __future__ import annotations

import argparse
import json
import time


def _mesh(device: str, n_slabs: int):
    import torch
    from gpu_physics_engine_torch.core.tiled_engine import default_device
    from gpu_physics_engine_torch.parallel.mesh import Mesh, make_mesh
    dev = default_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return make_mesh(n_slabs or 1, device=dev)
    have = torch.cuda.device_count()
    return Mesh([torch.device("cuda", i % have)
                 for i in range(n_slabs or have)])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--particles", type=int, default=1 << 20)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--world", type=float, nargs=2, default=(6096.0, 2096.0))
    p.add_argument("--gravity", type=float, nargs=2, default=(0.0, 0.0))
    p.add_argument("--devices", type=int, default=0,
                   help="slab count (0 = one per visible CUDA device)")
    p.add_argument("--device", default="cuda",
                   help="cuda (slabs spread over the cards), cpu, or one "
                        "indexed device for every slab")
    p.add_argument("--tile-cap", type=int, default=16)
    p.add_argument("--summary-json", action="store_true")
    args = p.parse_args(argv)

    import numpy as np

    from gpu_physics_engine_torch import SimConfig, StepParams
    from gpu_physics_engine_torch.parallel import tiled_shard

    mesh = _mesh(args.device, args.devices)
    n_dev = mesh.size
    cfg = SimConfig(
        max_particles=args.particles, initial_particles=args.particles,
        world_width=args.world[0], world_height=args.world[1],
        gravity=tuple(args.gravity), pipeline="tiled",
        tile_cap=args.tile_cap, solver="fast")

    rng = np.random.default_rng(0)
    positions = np.stack([
        rng.uniform(0.0, cfg.world_width, args.particles),
        rng.uniform(0.0, cfg.world_height, args.particles)],
        -1).astype(np.float32)
    radii = np.full(args.particles, cfg.initial_radius, np.float32)

    t0 = time.perf_counter()
    eng = tiled_shard.ShardedTiledEngine(
        cfg, mesh=mesh, initial_arrays=(positions, radii, None, None))
    eng.step(StepParams.make(cfg.dt))
    _ = eng.num_particles()  # waits for the device: set-up + first step
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    eng.run(args.steps)
    n_alive = eng.num_particles()  # waits for the device
    ms = (time.perf_counter() - t0) / args.steps * 1e3

    pos = eng.positions()
    # "deferred", not "dropped": a mover that finds no room keeps its slot
    # and retries the next step; nothing is lost
    summary = {
        "devices": n_dev,
        "particles": n_alive,
        "deferred": int(eng.state[0].overflow_count),
        "per_chip_deferred": [int(v) for v in eng.per_chip_overflow],
        "steps": args.steps,
        "ms_per_step": round(ms, 3),
        "finite": bool(np.isfinite(pos).all()),
        "compile_s": round(compile_s, 1),
    }
    print(f"mesh={n_dev} slabs on {sorted({str(d) for d in mesh.devices})}"
          f" | {n_alive} particles | {ms:.2f} ms/step | deferred="
          f"{summary['deferred']} (per-slab {summary['per_chip_deferred']})")
    if args.summary_json:
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
