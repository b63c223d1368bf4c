"""Integrator correctness: deterministic emitter visibility, occlusion,
furnace-style closed-form checks, mirror reflection, determinism
(SURVEY.md §4.2, §4.5)."""

import jax
import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.models.camera import Camera, generate_rays
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec, sphere_spec, icosphere
from gpupathtracer_tpu.render.integrator import IntegratorOptions, trace_paths
from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame
from meshes import triangle_mesh

EMITTER = {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0}
RED = {"type": "diffuse", "albedo": (1.0, 0.0, 0.0)}


def _trace(scene, o, d, bounces=1, seed=0, **kw):
    from gpupathtracer_tpu.ops import sampling

    opts = IntegratorOptions(bounces=bounces, tri_block=8, **kw)
    keys = sampling.path_keys(seed, jnp.arange(o.shape[0], dtype=jnp.uint32), impl=opts.rng)
    return np.asarray(trace_paths(scene, o, d, keys, opts))


def test_direct_emitter_hit_exact():
    scene = build_scene([plane_spec((0, 0, 0), (0, 0, 0), (4, 4, 4), mat_id=0)], [EMITTER], pad_to_multiple=8)
    o = jnp.asarray([[0.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    out = _trace(scene, o, d, bounces=1)
    np.testing.assert_allclose(out, [[2.0, 2.0, 2.0]], atol=1e-6)


def test_emitter_two_sided():
    """Reference emitters are two-sided (utilities.h:96-103)."""
    scene = build_scene([plane_spec((0, 0, 0), (0, 0, 0), (4, 4, 4), mat_id=0)], [EMITTER], pad_to_multiple=8)
    o = jnp.asarray([[0.0, 0.0, -5.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    out = _trace(scene, o, d, bounces=1)
    np.testing.assert_allclose(out, [[2.0, 2.0, 2.0]], atol=1e-6)


def test_miss_is_background():
    scene = build_scene([plane_spec((0, 0, 0), (0, 0, 0), (1, 1, 1), mat_id=0)], [EMITTER], pad_to_multiple=8)
    o = jnp.asarray([[3.0, 3.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    out = _trace(scene, o, d, bounces=2)
    np.testing.assert_allclose(out, 0.0, atol=1e-7)
    out_pink = _trace(scene, o, d, bounces=1, background=(1.0, 0.75, 0.79))
    np.testing.assert_allclose(out_pink, [[1.0, 0.75, 0.79]], atol=1e-6)


def test_one_bounce_diffuse_is_black():
    """Committed reference depth: a diffuse hit with no further bounce
    contributes nothing (radiance only from emitters)."""
    scene = build_scene(
        [plane_spec((0, 0, 0), (0, 0, 0), (4, 4, 4), mat_id=0)], [RED], pad_to_multiple=8
    )
    o = jnp.asarray([[0.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    out = _trace(scene, o, d, bounces=1)
    np.testing.assert_allclose(out, 0.0, atol=1e-7)


def test_furnace_diffuse_exact():
    """Diffuse surface fully enclosed by a two-sided emitter sphere: every
    cosine sample hits Le, so radiance = albedo * Le exactly (zero variance)."""
    albedo = (0.25, 0.5, 0.75)
    specs = [
        plane_spec((0, 0, 0), (0, 0, 0), (1, 1, 1), mat_id=0),
        mesh_spec(icosphere(2), scale=(20.0, 20.0, 20.0), mat_id=1, two_sided=True),
    ]
    scene = build_scene(specs, [{"type": "diffuse", "albedo": albedo}, EMITTER], pad_to_multiple=8)
    o = jnp.asarray([[0.0, 0.0, 3.0]] * 4)
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 4)
    out = _trace(scene, o, d, bounces=2, seed=3)
    expected = np.asarray(albedo) * 2.0
    np.testing.assert_allclose(out, np.tile(expected, (4, 1)), rtol=1e-4)


def test_mirror_reflects_to_emitter():
    """45° mirror bounces the ray into an emitter: radiance = specular * Le."""
    specs = [
        plane_spec((0, 0, 0), (45.0, 0.0, 0.0), (4, 4, 4), mat_id=0),  # mirror tilted 45° about x
        # Rx(+45) maps +z normal to (0,-s,c): a -z camera ray reflects to -y.
        plane_spec((0, -8.0, 0), (90.0, 0.0, 0.0), (40, 40, 40), mat_id=1),  # emitter below
    ]
    scene = build_scene(
        specs,
        [{"type": "mirror", "specular_color": (0.9, 0.8, 0.7)}, EMITTER],
        pad_to_multiple=8,
    )
    o = jnp.asarray([[0.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    out = _trace(scene, o, d, bounces=2)
    np.testing.assert_allclose(out, [[0.9 * 2, 0.8 * 2, 0.7 * 2]], rtol=1e-4)


def test_glass_sphere_energy_plausible():
    specs = [
        sphere_spec((0.0, 0.0, 0.0), radius=1.0, mat_id=0, subdivisions=2),
        mesh_spec(icosphere(2), scale=(20.0, 20.0, 20.0), mat_id=1, two_sided=True),
    ]
    specs[0] = specs[0].replace()  # glass must be two-sided; set via build below
    from gpupathtracer_tpu.models.scene import GeometrySpec
    import dataclasses

    s0 = specs[0]
    specs[0] = GeometrySpec(
        vertices=s0.vertices, normals=s0.normals, uvs=s0.uvs,
        position=s0.position, rotation_deg=s0.rotation_deg, scale=s0.scale,
        mat_id=0, two_sided=True,
    )
    scene = build_scene(
        specs,
        [{"type": "glass", "refractive_index": 1.5, "transmittance_color": (1.0, 1.0, 1.0)}, EMITTER],
        pad_to_multiple=8,
    )
    o = jnp.asarray([[0.0, 0.0, 5.0]] * 8)
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 8)
    out = _trace(scene, o, d, bounces=6, seed=11)
    # Straight-through glass into the surrounding emitter: close to Le = 2.
    assert np.isfinite(out).all()
    assert (out >= 0).all()
    np.testing.assert_allclose(out.mean(), 2.0, rtol=0.05)


def test_render_frame_deterministic():
    scene = build_scene(
        [
            mesh_spec(triangle_mesh(), mat_id=0),
            plane_spec((0.5, 0.5, -1.5), (0, 0, 0), (8, 8, 8), mat_id=1),
        ],
        [RED, EMITTER],
        pad_to_multiple=8,
    )
    cam = Camera.create(position=(0.5, 0.5, 3.0), width=32, height=32)
    settings = RenderSettings(width=32, height=32, spp=4, bounces=2, tri_block=8)
    img1 = np.asarray(render_frame(scene, cam, settings))
    img2 = np.asarray(render_frame(scene, cam, settings))
    np.testing.assert_array_equal(img1, img2)
    assert img1.shape == (32, 32, 3)
    assert np.isfinite(img1).all()


def test_render_config1_occlusion():
    """Config-1 style: the diffuse triangle occludes the emissive backdrop
    at 1 bounce — emitter pixels = Le, triangle pixels = 0."""
    scene = build_scene(
        [
            mesh_spec(triangle_mesh(), mat_id=0),
            plane_spec((0.5, 0.5, -1.5), (0, 0, 0), (8, 8, 8), mat_id=1),
        ],
        [RED, EMITTER],
        pad_to_multiple=8,
    )
    cam = Camera.create(position=(0.5, 0.5, 3.0), width=64, height=64)
    settings = RenderSettings(width=64, height=64, spp=1, bounces=1, jitter=False, tri_block=8)
    img = np.asarray(render_frame(scene, cam, settings))
    # Center of the image looks at the triangle interior -> black.
    # Triangle spans (0,0)-(1,1); camera at (0.5,0.5,3): its centroid ~(1/3,1/3).
    o, d = generate_rays(cam)
    from gpupathtracer_tpu.ops.intersect import intersect_brute, resolve_hits

    hit = intersect_brute(o, d, scene, tri_block=8)
    tri_mask = (np.asarray(hit.tri) == 0) & np.asarray(hit.hit)
    emit_mask = (np.asarray(hit.tri) >= 1) & np.asarray(hit.hit)
    flat = img.reshape(-1, 3)
    assert tri_mask.sum() > 50  # the triangle is visibly on screen
    np.testing.assert_allclose(flat[tri_mask], 0.0, atol=1e-6)
    np.testing.assert_allclose(flat[emit_mask], 2.0, atol=1e-5)


def test_russian_roulette_unbiased():
    """RR (rr_start) must not bias the estimator: mean radiance over many
    paths with roulette on equals the no-roulette mean within MC error.
    Scene: two facing diffuse planes inside a two-sided emitter dome, so
    paths genuinely survive several bounces and RR has victims to kill."""
    specs = [
        plane_spec((0, 0, -1.5), (0, 0, 0), (6, 6, 6), mat_id=0),
        plane_spec((0, 0, 1.5), (0, 180.0, 0), (6, 6, 6), mat_id=0),
        mesh_spec(icosphere(1), scale=(25.0, 25.0, 25.0), mat_id=1, two_sided=True),
    ]
    scene = build_scene(
        specs, [{"type": "diffuse", "albedo": (0.7, 0.5, 0.3)}, EMITTER], pad_to_multiple=8
    )
    r = 4096
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 0.0]]), (r, 1))
    # Aim at the -z plane from between the two planes, slightly scattered.
    ang = jnp.linspace(-0.3, 0.3, r)
    d = jnp.stack([jnp.sin(ang), jnp.zeros(r), -jnp.cos(ang)], axis=-1)

    out_no_rr = _trace(scene, o, d, bounces=6, seed=5)
    out_rr = _trace(scene, o, d, bounces=6, seed=5, rr_start=2)

    assert np.isfinite(out_rr).all()
    # RR must actually fire (identical outputs would mean it's inert).
    assert np.abs(out_rr - out_no_rr).max() > 1e-3
    np.testing.assert_allclose(out_rr.mean(axis=0), out_no_rr.mean(axis=0), rtol=0.05)


def test_normal_aov_parity_magnitudes():
    """Reference normal AOV uses the unnormalized inverse-transpose normal:
    a 5x-scaled plane's |n| is 1/5 (SURVEY.md §2.3.1)."""
    scene = build_scene(
        [plane_spec((0, 0, 0), (0, 0, 0), (5, 5, 5), mat_id=0)], [RED], pad_to_multiple=8
    )
    cam = Camera.create(position=(0.0, 0.0, 5.0), width=16, height=16)
    settings = RenderSettings(width=16, height=16, aov="normal", tri_block=8)
    img = np.asarray(render_frame(scene, cam, settings))
    center = img[8, 8]
    np.testing.assert_allclose(center, [0.0, 0.0, 0.2], atol=1e-5)
    settings_unit = RenderSettings(width=16, height=16, aov="normal_unit", tri_block=8)
    img_u = np.asarray(render_frame(scene, cam, settings_unit))
    np.testing.assert_allclose(img_u[8, 8], [0.0, 0.0, 1.0], atol=1e-5)


def test_material_set_specialization_bit_identical():
    """EP-analogue static specialization (IntegratorOptions.material_set):
    narrowing to the types the scene actually uses must be bit-identical to
    the full 4-type select chain — absent-type lanes cannot exist, and the
    select chain's values on present-type lanes are unchanged."""
    import dataclasses

    from gpupathtracer_tpu.render.renderer import scene_material_set

    scene = build_scene(
        [
            mesh_spec(triangle_mesh(), mat_id=0),
            plane_spec((0.5, 0.5, -1.5), (0, 0, 0), (8, 8, 8), mat_id=1),
        ],
        [RED, EMITTER],
        pad_to_multiple=8,
    )
    assert scene_material_set(scene) == (0, 1)  # emitter + diffuse only
    cam = Camera.create(position=(0.5, 0.5, 3.0), width=32, height=32)
    for estimator in ("naive", "nee", "mis"):
        settings = RenderSettings(
            width=32, height=32, spp=2, bounces=3, tri_block=8, estimator=estimator
        )
        # render_frame narrows automatically (concrete scene) ...
        img_narrow = np.asarray(render_frame(scene, cam, settings))
        # ... full set forced via a traced scene (tracer path keeps the
        # caller-provided default (0, 1, 2, 3)).
        import jax

        full = dataclasses.replace(settings)
        img_full = np.asarray(
            jax.jit(
                lambda s: render_frame(s, cam, full), static_argnums=()
            )(scene)
        )
        np.testing.assert_array_equal(img_narrow, img_full, err_msg=estimator)


def test_narrow_settings_respects_pinned_set():
    """narrow_settings only auto-narrows the full default (0,1,2,3); a
    caller-pinned set survives — e.g. forcing the full chain to share one
    compiled executable across scenes (ADVICE r3)."""
    from gpupathtracer_tpu.render.renderer import narrow_settings

    scene = build_scene(
        [mesh_spec(triangle_mesh(), mat_id=0)],
        [RED],
        pad_to_multiple=8,
    )
    default = RenderSettings(width=16, height=16, tri_block=8)
    assert narrow_settings(scene, default).material_set == (1,)  # diffuse only
    pinned = RenderSettings(width=16, height=16, tri_block=8, material_set=(0, 1, 2))
    assert narrow_settings(scene, pinned).material_set == (0, 1, 2)
