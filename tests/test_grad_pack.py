"""Grad-mode packing fast paths.

The packed scene entering the Pallas kernel is wholly detached
(stop_gradient at the kernel boundary), and liveness (valid/two_sided) is a
closure constant under ``jax.grad`` of geometry/materials — so grad mode
must keep the trimmed row set and the sort autos instead of silently
falling back to the 2×-block static-shape pack with sorting off. Fully
concrete scenes additionally cache their pack across frames (the per-call
eager re-pack made repeated-frame rendering pay pack cost per frame).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.models.camera import Camera
from gpupathtracer_tpu.models.materials import material_table
from gpupathtracer_tpu.models.scene import GeometrySpec, build_scene, icosphere, plane_spec
from gpupathtracer_tpu.ops import pallas_intersect as pi
from gpupathtracer_tpu.render.renderer import RenderSettings, narrow_settings, render_frame


def _demo_scene(albedo=(0.6, 0.5, 0.4), off=0.0, pad=128):
    sph = icosphere(1)
    light = plane_spec((0.0, 3.0, 0.0), (90.0, 0.0, 0.0), (4.0, 4.0, 4.0), mat_id=1)
    mats = material_table(
        [
            {"type": "diffuse", "albedo": tuple(albedo)},
            {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 4.0},
        ]
    )
    spec = GeometrySpec(
        vertices=jnp.asarray(sph.vertices) + off,
        normals=jnp.asarray(sph.normals),
        uvs=jnp.asarray(sph.uvs),
        position=jnp.zeros(3),
        rotation_deg=jnp.zeros(3),
        scale=jnp.ones(3),
        mat_id=0,
    )
    return build_scene([spec, light], mats, pad_to_multiple=pad)


def test_pack_cache_reuses_identical_buffers():
    scene = _demo_scene()
    p1 = pi.pack_scene(scene, tri_block=128)
    p2 = pi.pack_scene(scene, tri_block=128)
    assert p1 is p2, "same buffers must hit the pack cache"
    # Different tri_block → different entry.
    p3 = pi.pack_scene(scene, tri_block=256)
    assert p3 is not p1
    # New buffers (same values) → fresh pack.
    scene2 = scene.replace(v0=scene.v0 + 0.0)
    p4 = pi.pack_scene(scene2, tri_block=128)
    assert p4 is not p1
    np.testing.assert_array_equal(np.asarray(p4.tri_map), np.asarray(p1.tri_map))


def test_traced_geometry_keeps_trimmed_rows():
    """With concrete structure but traced v0, the pack keeps the eager
    (trimmed) block count — not the 2× static-shape fallback."""
    scene = _demo_scene()
    eager = pi.pack_scene(scene, tri_block=128)

    shapes = []

    def f(v0):
        packed = pi.pack_scene(scene.replace(v0=v0), tri_block=128)
        shapes.append(packed.w.shape)
        return packed.w.sum()

    jax.make_jaxpr(f)(scene.v0)
    assert shapes[0] == eager.w.shape

    # Fully-traced structure still takes the static full-copy fallback.
    shapes2 = []

    def g(v0, valid):
        packed = pi.pack_scene(scene.replace(v0=v0, valid=valid), tri_block=128)
        shapes2.append(packed.w.shape)
        return packed.w.sum()

    jax.make_jaxpr(g)(scene.v0, scene.valid)
    assert shapes2[0][0] >= shapes[0][0]


def test_narrow_settings_resolves_with_traced_geometry():
    scene = _demo_scene()
    st = RenderSettings(width=8, height=8, sort_rays="auto", sort_key="auto")

    resolved = []

    def f(v0):
        s2 = scene.replace(v0=v0)
        resolved.append(narrow_settings(s2, st))
        return v0.sum()

    jax.make_jaxpr(f)(scene.v0)
    out = resolved[0]
    assert isinstance(out.sort_rays, bool)
    assert out.sort_key in ("dir", "origin")
    # Material narrowing fired from the concrete structure fields.
    assert tuple(out.material_set) == (0, 1)


def test_narrow_settings_rows_round_up_to_block(monkeypatch):
    """The sort autos turn on from the packed row count (two-sided rows
    counted twice, as the kernel packs them) and only for the culling
    intersector; the XLA scan never sorts."""
    import gpupathtracer_tpu.render.renderer as renderer

    scene = _demo_scene()
    valid = np.asarray(scene.valid)
    rows = int(valid.sum() + (np.asarray(scene.two_sided) & valid).sum())
    assert rows > int(valid.sum()), "the light plane's rows are duplicated"
    auto = RenderSettings(width=8, height=8, intersector="pallas",
                          sort_rays="auto", sort_key="auto")
    monkeypatch.setattr(renderer, "SORT_RAYS_MIN_TRIANGLES", rows)
    st = narrow_settings(scene, auto)
    assert st.sort_rays is True and st.sort_key == "origin"
    monkeypatch.setattr(renderer, "SORT_RAYS_MIN_TRIANGLES", rows + 1)
    st = narrow_settings(scene, auto)
    assert st.sort_rays is False and st.sort_key == "dir"
    monkeypatch.setattr(renderer, "SORT_RAYS_MIN_TRIANGLES", 0)
    st = narrow_settings(scene, dataclasses.replace(auto, intersector="plucker"))
    assert st.sort_rays is False and st.sort_key == "dir"


def test_grad_mode_image_and_grads_match_fully_traced():
    """The trimmed grad-mode pack must produce the same forward values and
    gradients as the full static-shape traced pack (same hits, different
    packing only)."""
    cam = Camera.create(position=(0.0, 0.0, 4.0), fov_deg=45.0, width=16, height=16)
    st = RenderSettings(
        width=16, height=16, spp=2, bounces=2, tri_block=128,
        estimator="nee", intersector="pallas",
    )
    base = _demo_scene()

    def loss_trimmed(albedo, seed):
        m = base.materials.replace(albedo=base.materials.albedo.at[0].set(albedo))
        return jnp.mean(render_frame(base.replace(materials=m), cam, st, seed=seed))

    def loss_full(albedo, valid, seed):
        # Passing ``valid`` as a traced arg forces the static full-copy pack.
        m = base.materials.replace(albedo=base.materials.albedo.at[0].set(albedo))
        return jnp.mean(
            render_frame(base.replace(materials=m, valid=valid), cam, st, seed=seed)
        )

    a0 = jnp.asarray([0.6, 0.5, 0.4])
    v1, g1 = jax.jit(jax.value_and_grad(loss_trimmed))(a0, jnp.uint32(7))
    v2, g2 = jax.jit(jax.value_and_grad(loss_full, argnums=0))(a0, base.valid, jnp.uint32(7))
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-5, atol=1e-7)


def test_auto_fallback_is_logged():
    from gpupathtracer_tpu.render.renderer import _integrator_options
    from gpupathtracer_tpu.utils import metrics

    metrics._ONCE_KEYS.discard("auto_fallback:sort")
    n0 = len(metrics.RUNTIME_EVENTS)
    _integrator_options(RenderSettings(width=8, height=8, sort_rays="auto"))
    events = metrics.RUNTIME_EVENTS[n0:]
    assert any(e.get("event") == "auto_fallback" for e in events)
    # Deduped on repeat.
    n1 = len(metrics.RUNTIME_EVENTS)
    _integrator_options(RenderSettings(width=8, height=8, sort_rays="auto"))
    assert len(metrics.RUNTIME_EVENTS) == n1


def test_bvh_cache_reuses_identical_buffers():
    from gpupathtracer_tpu.render.renderer import _cached_bvh

    scene = _demo_scene()
    b1 = _cached_bvh(scene)
    b2 = _cached_bvh(scene)
    assert b1 is b2
    b3 = _cached_bvh(scene.replace(v0=scene.v0 + 0.0))
    assert b3 is not b1
