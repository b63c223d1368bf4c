"""Pipeline-parallel staged wavefront (parallel/pipeline.py): microbatched
bounce staging across the 'pipe' mesh axis is bit-identical to the
sequential bounce scan (SURVEY.md §2.4 PP row)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.models.camera import Camera
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.parallel.pipeline import make_pipe_mesh, render_frame_pipelined
from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame
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
        pad_to_multiple=128,
    )


CAMERA = Camera.create(position=(0.5, 0.5, 3.0), width=16, height=16)


@pytest.mark.parametrize("n_pipe,microbatches", [(4, 4), (4, 8), (8, 2)])
def test_pipelined_bitmatches_sequential(n_pipe, microbatches):
    settings = RenderSettings(
        width=16, height=16, spp=2, bounces=n_pipe, tri_block=128,
        intersector="plucker",
    )
    scene = _scene()
    mesh = make_pipe_mesh(n_pipe, devices=jax.devices()[:n_pipe])
    ref = np.asarray(render_frame(scene, CAMERA, settings))
    out = np.asarray(
        render_frame_pipelined(scene, CAMERA, settings, mesh, microbatches=microbatches)
    )
    np.testing.assert_array_equal(out, ref)


def test_pipelined_nee_bitmatches():
    """NEE shadow rays execute inside each stage's bounce — still exact."""
    settings = RenderSettings(
        width=16, height=16, spp=2, bounces=4, tri_block=128,
        intersector="plucker", estimator="nee",
    )
    scene = _scene()
    mesh = make_pipe_mesh(4, devices=jax.devices()[:4])
    ref = np.asarray(render_frame(scene, CAMERA, settings))
    out = np.asarray(render_frame_pipelined(scene, CAMERA, settings, mesh, microbatches=4))
    np.testing.assert_array_equal(out, ref)
