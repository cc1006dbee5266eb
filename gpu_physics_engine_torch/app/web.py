"""Browser front end (``gpu_physics_engine_tpu.app.web``): the analog of the
reference's web/wasm target (src/app.rs:9-75, src/lib.rs:1-40: winit and
wgpu compiled to wasm, a canvas in the page).

The engine cannot run in the browser, so the split is the inverse: the
simulation and the device render stay on the machine with the card, and
the browser is a thin canvas and input surface over HTTP (stdlib
http.server, no extra dependencies).  Open the URL, watch the particles,
drag the attractor, P to spawn, G for grid lines, the wheel to zoom,
WASD/arrows to pan.

  python -m gpu_physics_engine_torch.app.web --particles 1048576 --port 8000

(``--device cpu`` runs it on the CPU, at a small size.)  Endpoints:
  GET  /           the page (canvas + input JS, self-contained)
  GET  /frame.png  latest rendered frame (PNG, encode level 1)
  GET  /stats      {"fps": ..., "particles": ..., "frame": ...}
  POST /event      {"type": "move"|"button"|"key"|"wheel", ...}

Input events are queued and applied on the simulation thread between
steps through InputManager (utils/input.py, the reference keymap,
input_manager.rs:12-63); engine and device calls never run on HTTP
threads.  Frames render at display cadence with Viewer.render_engine
(the device compositor for the tiled engine; ``--preview-scale`` draws
at a fraction of the window and upscales on the host).
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>gpu-physics-engine-torch</title><style>
  body { margin: 0; background: #111; color: #ddd;
         font: 13px monospace; overflow: hidden; }
  #hud { position: fixed; top: 6px; left: 8px; opacity: 0.8; }
  canvas { display: block; margin: 0 auto; outline: none; }
</style></head><body>
<div id="hud">connecting…</div>
<canvas id="c" width="%(w)d" height="%(h)d" tabindex="0"></canvas>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
const hud = document.getElementById('hud');
function post(ev) { fetch('/event', {method: 'POST',
  body: JSON.stringify(ev)}).catch(() => {}); }
c.addEventListener('mousemove', e => {
  const r = c.getBoundingClientRect();
  post({type: 'move', x: e.clientX - r.left, y: e.clientY - r.top});
});
c.addEventListener('mousedown', () => post({type: 'button', pressed: true}));
c.addEventListener('mouseup', () => post({type: 'button', pressed: false}));
c.addEventListener('wheel', e => {
  e.preventDefault();
  post({type: 'wheel', delta: e.deltaY < 0 ? 1.0 : -1.0});
}, {passive: false});
window.addEventListener('keydown', e => post({type: 'key', key: e.key,
                                              pressed: true}));
window.addEventListener('keyup', e => post({type: 'key', key: e.key,
                                            pressed: false}));
c.focus();
let frames = 0, t0 = performance.now();
async function loop() {
  try {
    const img = await createImageBitmap(
      await (await fetch('/frame.png?' + frames)).blob());
    ctx.drawImage(img, 0, 0, c.width, c.height);
    frames++;
    if (frames %% 30 == 0) {
      const s = await (await fetch('/stats')).json();
      const fps = 30000 / (performance.now() - t0); t0 = performance.now();
      hud.textContent = s.particles + ' particles | display ' +
        fps.toFixed(1) + ' fps | sim frame ' + s.frame;
    }
  } catch (e) {}
  requestAnimationFrame(loop);
}
loop();
</script></body></html>"""


class WebApp:
    """Owns the engine, viewer and input trio and the simulation thread;
    the HTTP layer only reads the latest encoded frame and enqueues
    input."""

    def __init__(self, engine, viewer, preview_scale: int = 1,
                 steps_per_frame: int = 1):
        from gpu_physics_engine_torch.utils.input import InputManager
        self.engine = engine
        self.viewer = viewer
        self.preview_scale = preview_scale
        self.steps_per_frame = steps_per_frame
        self.events: "queue.Queue" = queue.Queue()
        self.running = False
        self._frame_lock = threading.Lock()
        self._frame_png = b""
        self._frame_idx = 0
        self._fps = 0.0
        self._particles = int(engine.num_particles())
        self.inputs = InputManager(engine, viewer, on_quit=self.stop)
        self._thread = None

    # ---- sim thread ----

    def _apply_events(self):
        while True:
            try:
                ev = self.events.get_nowait()
            except queue.Empty:
                return
            kind = ev.get("type")
            if kind == "move":
                self.inputs.process_cursor_moved((ev["x"], ev["y"]))
            elif kind == "button":
                self.inputs.process_mouse_input("left", bool(ev["pressed"]))
            elif kind == "key":
                self.inputs.process_keyboard_input(str(ev["key"]),
                                                   bool(ev["pressed"]))
            elif kind == "wheel":
                self.inputs.process_mouse_wheel(float(ev["delta"]))

    def _loop(self):
        try:
            self._loop_inner()
        except Exception:
            # a dead sim thread must be loud: the HTTP layer would keep
            # serving the last frame forever otherwise
            import traceback
            traceback.print_exc()
            self.running = False

    def _loop_inner(self):
        from gpu_physics_engine_torch.utils.png import encode_png
        eng = self.engine
        last = time.perf_counter()
        while self.running:
            self._apply_events()
            self.viewer.camera.update(max(time.perf_counter() - last, 1e-3))
            last = time.perf_counter()
            if self.steps_per_frame == 1:
                eng.step()
            else:
                eng.run(self.steps_per_frame)
            frame = self.viewer.render_engine(
                eng, preview_scale=self.preview_scale)
            png = encode_png(np.asarray(frame), level=1)
            # the count is read on the sim thread: HTTP threads never
            # touch the engine's tensors
            n_alive = int(eng.num_particles())
            with self._frame_lock:
                self._frame_png = png
                self._frame_idx += self.steps_per_frame
                self._particles = n_alive
            dt = time.perf_counter() - last
            self._fps = 0.9 * self._fps + 0.1 * (1.0 / max(dt, 1e-6))

    def start(self):
        self.running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self.running = False

    def join(self, timeout: float | None = None) -> None:
        """Wait for the sim thread to leave its loop (after ``stop``)."""
        if self._thread is not None:
            self._thread.join(timeout)

    # ---- HTTP layer state ----

    def frame_png(self) -> bytes:
        with self._frame_lock:
            return self._frame_png

    def stats(self) -> dict:
        with self._frame_lock:
            return {"fps": round(self._fps, 1),
                    "particles": self._particles,
                    "frame": self._frame_idx}


def make_server(app: WebApp, host: str = "127.0.0.1", port: int = 8000,
                screen=(1280, 720)) -> ThreadingHTTPServer:
    page = (_PAGE % {"w": screen[0], "h": screen[1]}).encode()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(200, page, "text/html")
            elif path == "/frame.png":
                png = app.frame_png()
                if not png:
                    self._send(503, b"no frame yet", "text/plain")
                else:
                    self._send(200, png, "image/png")
            elif path == "/stats":
                self._send(200, json.dumps(app.stats()).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path.split("?")[0] != "/event":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                ev = json.loads(self.rfile.read(n) or b"{}")
                app.events.put(ev)
                self._send(200, b"ok", "text/plain")
            except (ValueError, KeyError):
                self._send(400, b"bad event", "text/plain")

        def log_message(self, *a):  # quiet access log
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--particles", type=int, default=100_000)
    p.add_argument("--world", type=float, nargs=2, default=(3048.0, 1048.0))
    p.add_argument("--gravity", type=float, nargs=2, default=(0.0, 0.0))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--window", type=int, nargs=2, default=(1280, 720))
    p.add_argument("--pipeline", choices=("sorted", "bucket", "tiled"),
                   default="tiled")
    p.add_argument("--preview-scale", type=int, default=1,
                   help="draw at 1/s of the window, upscale on the host")
    p.add_argument("--steps-per-frame", type=int, default=1)
    p.add_argument("--fused", action="store_true",
                   help="accepted for the JAX package's CLI and ignored: "
                        "a frame is always step() then render_frame(), the "
                        "same work as step_render_frame()")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   dest="overrides", help="SimConfig overrides")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the engine (default cuda)")
    args = p.parse_args(argv)

    from gpu_physics_engine_torch import SimConfig, make_engine
    from gpu_physics_engine_torch.app.headless import apply_overrides
    from gpu_physics_engine_torch.render.viewer import Viewer

    cfg = SimConfig(
        max_particles=args.particles + 100_000,
        initial_particles=args.particles,
        world_width=args.world[0], world_height=args.world[1],
        gravity=tuple(args.gravity), pipeline=args.pipeline)
    cfg = apply_overrides(cfg, args.overrides)
    eng = make_engine(cfg, seed=args.seed, device=args.device)
    viewer = Viewer((cfg.world_width, cfg.world_height), tuple(args.window))

    app = WebApp(eng, viewer, preview_scale=args.preview_scale,
                 steps_per_frame=args.steps_per_frame)
    app.start()
    srv = make_server(app, args.host, args.port, tuple(args.window))
    print(f"serving on http://{args.host}:{srv.server_address[1]}/ "
          f"(Ctrl-C to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        app.stop()
        app.join(timeout=30.0)
        srv.server_close()


if __name__ == "__main__":
    main()
