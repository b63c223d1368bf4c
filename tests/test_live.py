"""Live progressive preview (render/live.py): refinement accumulates,
camera commands apply and reset accumulation, outputs refresh atomically,
and the HTTP page serves."""

import json
import os
import urllib.request

import numpy as np

from gpupathtracer_tpu.models.camera import Camera
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.render.live import apply_command, live_view
from gpupathtracer_tpu.render.renderer import RenderSettings
from meshes import triangle_mesh


def _scene():
    return build_scene(
        [
            mesh_spec(triangle_mesh(), mat_id=0),
            plane_spec((0.5, 0.5, -1.5), (0, 0, 0), (8, 8, 8), mat_id=1),
        ],
        [
            {"type": "diffuse", "albedo": (1.0, 0.0, 0.0)},
            {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
        ],
        pad_to_multiple=8,
    )


SETTINGS = RenderSettings(width=24, height=24, spp=8, bounces=2, tri_block=8)
CAMERA = Camera.create(position=(0.5, 0.5, 3.0), width=24, height=24)


def test_live_refines_to_max_spp(tmp_path):
    out = str(tmp_path / "live")
    cam, spp = live_view(
        _scene(), CAMERA, SETTINGS, out,
        chunk_spp=2, max_spp=6, command_source=lambda: [],
    )
    assert spp == 6
    status = json.load(open(os.path.join(out, "status.json")))
    assert status["spp"] == 6 and status["frame"] == 3
    from gpupathtracer_tpu.utils.image import read_png

    img = read_png(os.path.join(out, "live.png"))
    assert img.shape == (24, 24, 3)
    assert img.max() > 200  # the emitter backdrop is visible


def test_live_camera_commands_reset_accumulation(tmp_path):
    out = str(tmp_path / "live")
    feed = iter([[], ["w"], [], ["quit"]])

    def source():
        return next(feed, ["quit"])

    cam, spp = live_view(
        _scene(), CAMERA, SETTINGS, out,
        chunk_spp=2, max_spp=100, command_source=source,
    )
    # 'w' moved the camera forward (reference velocity 0.2) and reset the film:
    # chunks after the move accumulated 2 chunks x 2 spp.
    np.testing.assert_allclose(float(cam.position[2]), 2.8, atol=1e-5)
    assert spp == 4


def test_apply_command_mouse_and_reset():
    cam = apply_command(CAMERA, "mouse 10 0")
    assert float(cam.yaw) != float(CAMERA.yaw)
    cam2 = apply_command(CAMERA, "r")
    np.testing.assert_allclose(np.asarray(cam2.position), [0.0, 0.0, 15.0])
    assert apply_command(CAMERA, "bogus") is None


def test_live_http_serves_page(tmp_path):
    out = str(tmp_path / "live")
    cam, spp = live_view(
        _scene(), CAMERA, SETTINGS, out,
        chunk_spp=2, max_spp=2, command_source=lambda: [], http_port=0,
    )
    # Server shut down at exit; the page + artifacts exist on disk.
    html = open(os.path.join(out, "index.html")).read()
    assert "live.png" in html and "status.json" in html
    assert json.load(open(os.path.join(out, "server.json")))["port"] > 0


def test_live_http_live_fetch(tmp_path):
    """Fetch the page while the loop is still running (command source stalls
    one extra poll so the server is up during the request)."""
    out = str(tmp_path / "live")
    state = {"fetched": None}

    calls = {"n": 0}

    def source():
        calls["n"] += 1
        if calls["n"] == 2:
            port = json.load(open(os.path.join(out, "server.json")))["port"]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/index.html", timeout=5) as r:
                state["fetched"] = r.read().decode()
            return ["quit"]
        return []

    live_view(
        _scene(), CAMERA, SETTINGS, out,
        chunk_spp=1, max_spp=8, command_source=source, http_port=0,
    )
    assert state["fetched"] and "firefly live" in state["fetched"]
