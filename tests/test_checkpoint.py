"""Checkpoint/resume and fault tolerance (SURVEY.md §4-5): a killed and
resumed progressive render is bit-identical to an uninterrupted one."""

import numpy as np

from gpupathtracer_tpu.models.camera import Camera
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.render.progressive import render_progressive
from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame
from gpupathtracer_tpu.utils import checkpoint as ckpt
from gpupathtracer_tpu.utils.metrics import read_events
from meshes import triangle_mesh

RED = {"type": "diffuse", "albedo": (1.0, 0.0, 0.0)}
EMITTER = {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0}


def _scene():
    return build_scene(
        [
            mesh_spec(triangle_mesh(), mat_id=0),
            plane_spec((0.5, 0.5, -1.5), (0, 0, 0), (8, 8, 8), mat_id=1),
        ],
        [RED, EMITTER],
        pad_to_multiple=8,
    )


SETTINGS = RenderSettings(width=16, height=16, spp=8, bounces=2, tri_block=8)
CAMERA = Camera.create(position=(0.5, 0.5, 3.0), width=16, height=16)


def test_progressive_equals_oneshot():
    scene = _scene()
    ref = np.asarray(render_frame(scene, CAMERA, SETTINGS))
    prog = render_progressive(scene, CAMERA, SETTINGS, chunk_spp=3)
    np.testing.assert_allclose(prog, ref, atol=1e-6)


def test_kill_and_resume_bit_identical(tmp_path):
    scene = _scene()
    path = str(tmp_path / "film.npz")

    # "Crash" after the first chunk: render only 3 of 8 samples.
    partial_settings = SETTINGS
    film = np.zeros((16, 16, 3), np.float32)
    import jax.numpy as jnp

    from gpupathtracer_tpu.render.renderer import render_samples

    chunk = np.asarray(render_samples(scene, CAMERA, partial_settings, jnp.uint32(0), 3))
    ckpt.save_film(path, chunk, 3, partial_settings)

    # Resume: must complete samples 3..8 and match the uninterrupted render.
    resumed = render_progressive(
        scene, CAMERA, SETTINGS, chunk_spp=2, checkpoint_path=path
    )
    ref = np.asarray(render_frame(scene, CAMERA, SETTINGS))
    np.testing.assert_allclose(resumed, ref, atol=1e-6)

    # The final checkpoint records all samples.
    loaded = ckpt.load_film(path, SETTINGS)
    assert loaded is not None and loaded[1] == 8


def test_checkpoint_rejects_mismatched_settings(tmp_path):
    scene = _scene()
    path = str(tmp_path / "film.npz")
    ckpt.save_film(path, np.zeros((16, 16, 3), np.float32), 4, SETTINGS)
    other = RenderSettings(width=16, height=16, spp=8, bounces=2, tri_block=8, seed=999)
    assert ckpt.load_film(path, other) is None


def test_metrics_stream(tmp_path):
    scene = _scene()
    metrics = str(tmp_path / "metrics.jsonl")
    render_progressive(scene, CAMERA, SETTINGS, chunk_spp=4, metrics_path=metrics)
    events = read_events(metrics)
    assert len(events) == 2
    assert events[-1]["samples_done"] == 8
    assert events[0]["rays_per_sec"] > 0


def test_train_state_roundtrip(tmp_path):
    import jax.numpy as jnp

    path = str(tmp_path / "train.pkl")
    params = {"a": jnp.ones((3,)), "b": {"c": jnp.zeros((2, 2))}}
    ckpt.save_train_state(path, params, ("opt", jnp.ones(1)), step=7)
    loaded = ckpt.load_train_state(path)
    assert loaded["step"] == 7
    np.testing.assert_allclose(loaded["params"]["a"], 1.0)
