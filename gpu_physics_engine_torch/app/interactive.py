"""Windowed app (``gpu_physics_engine_tpu.app.interactive``; needs
matplotlib, imported when ``main`` runs).

The analog of the reference's winit event loop and 1280x720 window
(src/app.rs:31-100) driving State::render_loop.  The engine steps on its
device; the viewer draws a frame at display cadence (the device
compositor for the tiled engine, the host splat for the array Engine) and
blits it into a matplotlib window, which also supplies the events for the
InputManager keymap (Esc/P/G/WASD, the mouse attractor, wheel zoom).
Without a display, use app/headless.py with --render-every, or pass
``--frames N`` under matplotlib's Agg backend.

  python -m gpu_physics_engine_torch.app.interactive --particles 100000 \\
      --pipeline tiled
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--particles", type=int, default=100_000)
    p.add_argument("--world", type=float, nargs=2, default=(3048.0, 1048.0))
    p.add_argument("--gravity", type=float, nargs=2, default=(0.0, 0.0))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--window", type=int, nargs=2, default=(1280, 720))
    p.add_argument("--frames", type=int, default=0,
                   help="exit after N frames (0 = run until closed); "
                        "for smoke tests on headless backends")
    p.add_argument("--pipeline", choices=("sorted", "bucket", "tiled"),
                   default="sorted",
                   help="tiled = the production engine, whose frames are "
                        "drawn on its device and downloaded as one image")
    p.add_argument("--preview-scale", type=int, default=1,
                   help="draw device frames at window/s and upscale on "
                        "the host")
    p.add_argument("--fused", action="store_true",
                   help="accepted for the JAX package's CLI and ignored: "
                        "a frame is always step() then render_frame(), the "
                        "same work as step_render_frame()")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   dest="overrides", help="SimConfig overrides (headless "
                                          "--set semantics)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the engine (default cuda)")
    args = p.parse_args(argv)

    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise SystemExit(
            "the window app needs matplotlib; use app.headless "
            "--render-every to write PNG frames instead") from e

    from gpu_physics_engine_torch import SimConfig, make_engine
    from gpu_physics_engine_torch.app.headless import apply_overrides
    from gpu_physics_engine_torch.render.viewer import Viewer
    from gpu_physics_engine_torch.utils.input import InputManager

    cfg = SimConfig(
        max_particles=args.particles + 100_000,
        initial_particles=args.particles,
        world_width=args.world[0], world_height=args.world[1],
        gravity=tuple(args.gravity), pipeline=args.pipeline)
    cfg = apply_overrides(cfg, args.overrides)
    eng = make_engine(cfg, seed=args.seed, device=args.device)
    viewer = Viewer((cfg.world_width, cfg.world_height), tuple(args.window))

    running = {"on": True}
    im = None
    fig, ax = plt.subplots(figsize=(args.window[0] / 100, args.window[1] / 100))
    ax.set_axis_off()
    fig.subplots_adjust(0, 0, 1, 1)
    inputs = InputManager(eng, viewer, on_quit=lambda: running.update(on=False))

    def on_key(event, pressed):
        if event.key:
            inputs.process_keyboard_input(event.key, pressed)

    def on_move(event):
        if event.x is not None:
            # matplotlib's y origin is bottom-left; InputManager's top-left
            inputs.process_cursor_moved((event.x, args.window[1] - event.y))

    fig.canvas.mpl_connect("key_press_event", lambda e: on_key(e, True))
    fig.canvas.mpl_connect("key_release_event", lambda e: on_key(e, False))
    fig.canvas.mpl_connect("motion_notify_event", on_move)
    fig.canvas.mpl_connect(
        "button_press_event", lambda e: inputs.process_mouse_input("left", True))
    fig.canvas.mpl_connect(
        "button_release_event",
        lambda e: inputs.process_mouse_input("left", False))
    fig.canvas.mpl_connect(
        "scroll_event", lambda e: inputs.process_mouse_wheel(e.step))
    fig.canvas.mpl_connect(
        "close_event", lambda e: running.update(on=False))

    plt.ion()
    plt.show()
    n_frames = 0
    try:
        with eng.timer:
            while running["on"]:
                viewer.camera.update(eng.timer.get_delta() or 1 / 60)
                eng.step()
                frame = viewer.render_engine(
                    eng, preview_scale=args.preview_scale)
                if im is None:
                    im = ax.imshow(frame)
                else:
                    im.set_data(frame)
                fig.canvas.draw_idle()
                fig.canvas.flush_events()
                n_frames += 1
                if args.frames and n_frames >= args.frames:
                    running["on"] = False
    finally:
        plt.close(fig)
    return n_frames


if __name__ == "__main__":
    main()
