"""Live progressive preview — this framework's answer to the reference's
GLFW viewer loop (utilities.h:434-778) without GL.

The reference couples CUDA to an OpenGL PBO and redraws a textured quad per
frame with WASD/arrow camera controls (utilities.h:858-893). Here the same
Camera model (models/camera.py::move / mouse_move — the exact ProcessKeyboard
/ ProcessMouseMovement ports) drives a progressive-refinement loop:

- samples accumulate chunk-by-chunk into a Film (sample-exact, same
  machinery as checkpointed rendering);
- after every chunk the running mean is written ATOMICALLY to ``live.png``
  (+ ``status.json``) in the output directory — any image viewer that
  auto-reloads, or the built-in HTTP page (``--http``), acts as the swap
  chain;
- camera commands (stdin tokens or any injected source) apply between
  chunks; a camera change restarts accumulation at sample 0, which is the
  reference viewer's behavior (it re-renders 1 spp per frame from scratch).

Commands: w/s/a/d/q/e (move), left/right/up/down (yaw/pitch),
``mouse DX DY``, r (reset), quit.
"""

from __future__ import annotations

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.models.camera import Camera, mouse_move, move
from gpupathtracer_tpu.render.film import Film, to_u8
from gpupathtracer_tpu.render.renderer import RenderSettings, render_samples
from gpupathtracer_tpu.utils.image import write_png

_KEYMAP = {
    "w": 0, "s": 1, "a": 2, "d": 3, "q": 4, "e": 5,
    "left": 6, "right": 7, "up": 8, "down": 9, "r": 10,
}

_INDEX_HTML = """<!doctype html>
<title>firefly live</title>
<body style="margin:0;background:#111;display:grid;place-items:center;height:100vh">
<div><img id="v" style="image-rendering:pixelated;max-width:95vw"/>
<pre id="s" style="color:#9a9">connecting...</pre></div>
<script>
async function tick(){
  document.getElementById('v').src = 'live.png?' + Date.now();
  try {
    const r = await fetch('status.json?' + Date.now());
    document.getElementById('s').textContent = JSON.stringify(await r.json());
  } catch (e) {}
}
setInterval(tick, 500); tick();
</script>
"""


def stdin_commands():
    """Non-blocking stdin line poller (POSIX select) — the default command
    source for ``firefly view --live``."""
    import select
    import sys

    def poll():
        cmds = []
        while select.select([sys.stdin], [], [], 0)[0]:
            line = sys.stdin.readline()
            if not line:
                cmds.append("quit")
                break
            line = line.strip().lower()
            if line:
                cmds.append(line)
        return cmds

    return poll


def _serve(out_dir: str, port: int):
    import functools
    import http.server

    handler = functools.partial(
        http.server.SimpleHTTPRequestHandler, directory=out_dir
    )
    handler.log_message = lambda *a, **k: None  # quiet
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd


def _atomic_png(path: str, u8: np.ndarray):
    tmp = path + ".tmp.png"
    write_png(tmp, u8)
    os.replace(tmp, path)


def apply_command(camera: Camera, cmd: str) -> Camera | None:
    """One viewer command → new Camera, or None if unrecognized/quit."""
    if cmd in _KEYMAP:
        return move(camera, _KEYMAP[cmd])
    if cmd.startswith("mouse"):
        parts = cmd.split()
        if len(parts) == 3:
            try:
                return mouse_move(camera, float(parts[1]), float(parts[2]))
            except ValueError:
                return None
    return None


def live_view(
    scene,
    camera: Camera,
    settings: RenderSettings,
    out_dir: str,
    chunk_spp: int = 2,
    max_spp: int | None = None,
    command_source=None,
    http_port: int | None = None,
    gamma: float = 2.2,
    idle_sleep: float = 0.25,
):
    """Run the live loop; returns (final_camera, samples_accumulated).

    ``command_source()`` -> list of pending command strings (non-blocking);
    None = interactive stdin. ``max_spp`` bounds refinement per camera pose;
    with no command source the loop exits when it is reached (headless /
    test mode), otherwise it idles waiting for input.
    """
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "index.html"), "w") as f:
        f.write(_INDEX_HTML)
    httpd = None
    if http_port is not None:
        httpd = _serve(out_dir, http_port)  # port 0 = OS-assigned
        with open(os.path.join(out_dir, "server.json"), "w") as f:
            json.dump({"port": httpd.server_address[1]}, f)

    # Interactive (idle at max_spp, wait for commands) only on real stdin;
    # injected sources own the exit (tests/headless drivers say "quit").
    interactive = command_source is None
    poll = command_source if command_source is not None else stdin_commands()

    h, w = settings.height, settings.width
    film = Film(radiance_sum=np.zeros((h, w, 3), np.float32), sample_count=np.float32(0))
    frame_idx = 0
    try:
        while True:
            moved = False
            quit_now = False
            for cmd in poll():
                if cmd == "quit":
                    quit_now = True
                    break
                new_cam = apply_command(camera, cmd)
                if new_cam is not None:
                    camera = new_cam
                    moved = True
            if quit_now:
                break
            if moved:
                film = Film(
                    radiance_sum=np.zeros((h, w, 3), np.float32),
                    sample_count=np.float32(0),
                )

            done = int(film.sample_count)
            if max_spp is not None and done >= max_spp:
                if not interactive:
                    break
                time.sleep(idle_sleep)
                continue

            n = chunk_spp if max_spp is None else min(chunk_spp, max_spp - done)
            t0 = time.perf_counter()
            chunk = np.asarray(
                jax.device_get(render_samples(scene, camera, settings, jnp.uint32(done), n))
            )
            dt = time.perf_counter() - t0
            film = film.add_samples(chunk, n)
            frame_idx += 1

            _atomic_png(os.path.join(out_dir, "live.png"), to_u8(np.asarray(film.to_image()), gamma=gamma))
            status = {
                "spp": int(film.sample_count),
                "frame": frame_idx,
                "chunk_seconds": round(dt, 3),
                "rays_per_sec": round(w * h * n * settings.bounces / max(dt, 1e-9), 1),
                "camera": {
                    "position": [round(float(x), 3) for x in np.asarray(camera.position)],
                    "yaw": round(float(camera.yaw), 2),
                    "pitch": round(float(camera.pitch), 2),
                },
            }
            tmp = os.path.join(out_dir, "status.json.tmp")
            with open(tmp, "w") as f:
                json.dump(status, f)
            os.replace(tmp, os.path.join(out_dir, "status.json"))
    finally:
        if httpd is not None:
            httpd.shutdown()
    return camera, int(film.sample_count)
