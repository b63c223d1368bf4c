"""The PRODUCTION distributed path: the Pallas kernel inside shard_map.

On GPUs ``render_frame_distributed`` resolves "auto" to the Pallas kernel
inside the shard_map body. These tests run that exact composition
(pack-under-shard_map static shapes, kernel launch under manual
collectives) through the Pallas interpreter on the virtual-device mesh,
asserting bit-identity with the single-device Pallas render across all
three scene strategies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.models.camera import Camera
from gpupathtracer_tpu.models.materials import material_table
from gpupathtracer_tpu.models.scene import GeometrySpec, build_scene, icosphere, plane_spec
from gpupathtracer_tpu.parallel.mesh import make_mesh
from gpupathtracer_tpu.parallel.render import render_frame_distributed
from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 virtual devices"
)


def _scene(pad=256):
    sph = icosphere(1)
    light = plane_spec((0.0, 3.0, 0.0), (90.0, 0.0, 0.0), (4.0, 4.0, 4.0), mat_id=1)
    mats = material_table(
        [
            {"type": "diffuse", "albedo": (0.6, 0.5, 0.4)},
            {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 4.0},
        ]
    )
    spec = GeometrySpec(
        vertices=jnp.asarray(sph.vertices),
        normals=jnp.asarray(sph.normals),
        uvs=jnp.asarray(sph.uvs),
        position=jnp.zeros(3),
        rotation_deg=jnp.zeros(3),
        scale=jnp.ones(3),
        mat_id=0,
    )
    return build_scene([spec, light], mats, pad_to_multiple=pad)


SETTINGS = RenderSettings(
    width=16, height=16, spp=2, bounces=2, tri_block=8,
    estimator="nee", intersector="pallas",
)


@pytest.fixture(scope="module")
def single_device_frame():
    scene = _scene()
    camera = Camera.create(position=(0.0, 0.0, 4.0), fov_deg=45.0, width=16, height=16)
    return scene, camera, np.asarray(render_frame(scene, camera, SETTINGS))


@pytest.mark.parametrize("strategy", ["allgather", "ring", "ulysses"])
def test_pallas_inside_shard_map_bit_identical(single_device_frame, strategy):
    scene, camera, ref = single_device_frame
    mesh = make_mesh(n_data=2, n_scene=2, devices=jax.devices()[:4])
    img = np.asarray(
        render_frame_distributed(scene, camera, SETTINGS, mesh, scene_strategy=strategy)
    )
    np.testing.assert_array_equal(img, ref)


def test_pallas_shard_map_distributed_gradient(single_device_frame):
    """jax.grad THROUGH shard_map with the Pallas kernel in the body — the
    full production training-step composition."""
    scene, camera, ref = single_device_frame
    mesh = make_mesh(n_data=2, n_scene=2, devices=jax.devices()[:4])
    target = jnp.asarray(ref)

    def loss(albedo):
        m = scene.materials.replace(albedo=scene.materials.albedo.at[0].set(albedo))
        s = scene.replace(materials=m)
        img = render_frame_distributed(s, camera, SETTINGS, mesh, scene_strategy="ulysses")
        return jnp.mean((img - target) ** 2)

    a0 = jnp.asarray([0.3, 0.7, 0.5])
    g_dist = jax.grad(loss)(a0)

    def loss_single(albedo):
        m = scene.materials.replace(albedo=scene.materials.albedo.at[0].set(albedo))
        img = render_frame(scene.replace(materials=m), camera, SETTINGS)
        return jnp.mean((img - target) ** 2)

    g_single = jax.grad(loss_single)(a0)
    assert bool(jnp.isfinite(g_dist).all())
    np.testing.assert_allclose(np.asarray(g_dist), np.asarray(g_single), rtol=1e-5, atol=1e-8)


def test_pallas_shard_map_mask_compaction(single_device_frame):
    """Pure-DP distributed render with mask compaction (the live mask goes
    into the kernel's frustum pre-pass inside the shard_map body) is
    bit-identical to the single-device render (compaction mode never
    changes a sample)."""
    scene, camera, ref = single_device_frame
    mesh = make_mesh(n_data=4, n_scene=1, devices=jax.devices()[:4])
    masked = dataclasses.replace(SETTINGS, compact_mode="mask")
    img = np.asarray(render_frame_distributed(scene, camera, masked, mesh))
    np.testing.assert_array_equal(img, ref)
