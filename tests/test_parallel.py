"""Distributed tests on the 8-virtual-device CPU mesh (SURVEY.md §4.4-4.5):
sharded rendering equals single-device bit-for-bit across mesh shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.models.camera import Camera
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.parallel.mesh import make_mesh
from gpupathtracer_tpu.parallel.render import render_frame_distributed
from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame
from meshes import triangle_mesh

RED = {"type": "diffuse", "albedo": (1.0, 0.0, 0.0)}
EMITTER = {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0}


def _scene(pad=128):
    return build_scene(
        [
            mesh_spec(triangle_mesh(), mat_id=0),
            plane_spec((0.5, 0.5, -1.5), (0, 0, 0), (8, 8, 8), mat_id=1),
        ],
        [RED, EMITTER],
        pad_to_multiple=pad,
    )


SETTINGS = RenderSettings(
    width=32, height=32, spp=2, bounces=2, tri_block=128, intersector="plucker"
)
CAMERA = Camera.create(position=(0.5, 0.5, 3.0), width=32, height=32)


def test_eight_devices_available():
    assert jax.device_count() >= 8  # conftest forces the virtual CPU mesh


@pytest.mark.parametrize("n_data,n_scene", [(8, 1), (4, 2), (2, 4), (1, 8), (4, 1), (2, 2)])
def test_distributed_bitmatches_single(n_data, n_scene):
    scene = _scene(pad=128 * max(n_scene, 1))
    mesh = make_mesh(n_data=n_data, n_scene=n_scene, devices=jax.devices()[: n_data * n_scene])
    ref = np.asarray(render_frame(scene, CAMERA, SETTINGS))
    out = np.asarray(render_frame_distributed(scene, CAMERA, SETTINGS, mesh))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n_data,n_scene", [(4, 2), (2, 4), (1, 8)])
def test_ring_rotation_bitmatches_single(n_data, n_scene):
    """The ppermute ring strategy (scene shards rotate, rays resident) is
    bit-identical to single-device and to the all-gather strategy."""
    scene = _scene(pad=128 * n_scene)
    mesh = make_mesh(n_data=n_data, n_scene=n_scene, devices=jax.devices()[: n_data * n_scene])
    ref = np.asarray(render_frame(scene, CAMERA, SETTINGS))
    out = np.asarray(
        render_frame_distributed(scene, CAMERA, SETTINGS, mesh, scene_strategy="ring")
    )
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n_data,n_scene", [(4, 2), (2, 4), (1, 8)])
def test_ulysses_reshard_bitmatches_single(n_data, n_scene):
    """The all-to-all reshard strategy (pixels sharded over both axes;
    rays change layout around the intersect phase) is bit-identical to
    single-device and to the other two strategies."""
    scene = _scene(pad=128 * n_scene)
    mesh = make_mesh(n_data=n_data, n_scene=n_scene, devices=jax.devices()[: n_data * n_scene])
    ref = np.asarray(render_frame(scene, CAMERA, SETTINGS))
    out = np.asarray(
        render_frame_distributed(scene, CAMERA, SETTINGS, mesh, scene_strategy="ulysses")
    )
    np.testing.assert_array_equal(out, ref)


def test_ulysses_nee_matches():
    """Shadow rays route through the ulysses reshard too (custom intersect
    fn drives the occlusion fallback) — NEE frames must still agree."""
    scene = _scene(pad=256)
    mesh = make_mesh(n_data=2, n_scene=2, devices=jax.devices()[:4])
    settings = RenderSettings(
        width=16, height=16, spp=2, bounces=2, tri_block=128,
        intersector="plucker", estimator="nee",
    )
    cam = Camera.create(position=(0.5, 0.5, 3.0), width=16, height=16)
    ref = np.asarray(render_frame(scene, cam, settings))
    out = np.asarray(
        render_frame_distributed(scene, cam, settings, mesh, scene_strategy="ulysses")
    )
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_distributed_nee_matches():
    scene = _scene(pad=256)
    mesh = make_mesh(n_data=4, n_scene=2, devices=jax.devices()[:8])
    settings = RenderSettings(
        width=16, height=16, spp=2, bounces=2, tri_block=128,
        intersector="plucker", estimator="nee",
    )
    cam = Camera.create(position=(0.5, 0.5, 3.0), width=16, height=16)
    ref = np.asarray(render_frame(scene, cam, settings))
    out = np.asarray(render_frame_distributed(scene, cam, settings, mesh))
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_distributed_gradients():
    """jax.grad through the shard_map render (DP gradient psum)."""
    mesh = make_mesh(n_data=4, n_scene=1, devices=jax.devices()[:4])
    settings = RenderSettings(
        width=16, height=16, spp=1, bounces=2, tri_block=128,
        intersector="plucker", estimator="nee", jitter=False,
    )
    cam = Camera.create(position=(0.5, 0.5, 3.0), width=16, height=16)

    def loss(albedo):
        scene = _scene()
        mats = scene.materials
        scene = scene.replace(materials=mats.replace(albedo=mats.albedo.at[0].set(albedo)))
        return jnp.mean(render_frame_distributed(scene, cam, settings, mesh))

    g = jax.grad(loss)(jnp.asarray([1.0, 0.0, 0.0]))
    assert bool(jnp.isfinite(g).all())


def test_graft_entry_single():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (64, 64, 3)
    assert bool(jnp.isfinite(out).all())


def test_graft_entry_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
