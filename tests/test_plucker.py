"""Plücker/MXU intersection backends vs the Möller–Trumbore oracle
(SURVEY.md §7.4: interpret-mode parity tests vs jnp brute force)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.models.obj import MeshData
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.ops.intersect import intersect_brute
from gpupathtracer_tpu.ops.pallas_intersect import intersect_pallas, pack_scene
from gpupathtracer_tpu.ops.plucker import pack_triangles, intersect_plucker_jnp
from meshes import triangle_mesh


def random_scene(seed=0, pad=128):
    rng = np.random.default_rng(seed)

    def mk(n, s):
        t = rng.normal(size=(n, 3, 3)).astype(np.float32) * s
        return MeshData(
            vertices=t,
            normals=np.zeros((n, 3, 3), np.float32),
            uvs=np.zeros((n, 3, 2), np.float32),
        )

    scene = build_scene(
        [
            mesh_spec(mk(150, 2)),
            mesh_spec(mk(50, 2), two_sided=True),
            plane_spec((0, 0, 0), (10, 20, 0), (3, 3, 3)),
        ],
        [{"type": "diffuse"}],
        pad_to_multiple=pad,
    )
    r = 800
    o = jnp.asarray(rng.normal(size=(r, 3)) * 4, jnp.float32)
    draw = rng.normal(size=(r, 3)).astype(np.float32)
    d = jnp.asarray(draw / np.linalg.norm(draw, axis=1, keepdims=True))
    return scene, o, d


def test_plucker_jnp_matches_oracle():
    scene, o, d = random_scene()
    h_mt = intersect_brute(o, d, scene, tri_block=128)
    h_pl = intersect_plucker_jnp(o, d, pack_triangles(scene, tri_block=128))
    # fp-boundary cases may differ; demand >99.9% exact agreement and
    # identical t where the winning triangle agrees.
    agree = np.asarray(h_mt.tri) == np.asarray(h_pl.tri)
    assert agree.mean() > 0.999
    same = agree & np.asarray(h_mt.hit)
    np.testing.assert_allclose(
        np.asarray(h_pl.t)[same], np.asarray(h_mt.t)[same], rtol=1e-4, atol=1e-4
    )


def test_pallas_interpret_matches_plucker_jnp():
    scene, o, d = random_scene(seed=1)
    h_pl = intersect_plucker_jnp(o, d, pack_triangles(scene, tri_block=128))
    h_pa = intersect_pallas(o, d, pack_scene(scene, tri_block=128), ray_tile=256, interpret=True)
    # Same math modulo two-sided duplication — demand near-total agreement
    # (fp-boundary cases only may differ).
    agree = np.asarray(h_pa.tri) == np.asarray(h_pl.tri)
    assert agree.mean() > 0.999
    same = agree & np.asarray(h_pl.hit)
    np.testing.assert_allclose(
        np.asarray(h_pa.t)[same], np.asarray(h_pl.t)[same], rtol=1e-5, atol=1e-5
    )


def test_pallas_ray_padding():
    scene, o, d = random_scene(seed=2)
    packed = pack_scene(scene, tri_block=128)
    # 800 rays with tile 512 forces padding.
    h = intersect_pallas(o, d, packed, ray_tile=512, interpret=True)
    h2 = intersect_pallas(o, d, packed, ray_tile=256, interpret=True)
    np.testing.assert_array_equal(np.asarray(h.tri), np.asarray(h2.tri))


def test_pallas_two_sided_duplication_semantics():
    """Back-face hits on two-sided geometry resolve to the ORIGINAL row."""
    tri = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    mesh = MeshData(
        vertices=tri, normals=np.zeros((1, 3, 3), np.float32), uvs=np.zeros((1, 3, 2), np.float32)
    )
    scene = build_scene(
        [mesh_spec(mesh, two_sided=True)], [{"type": "diffuse"}], pad_to_multiple=128
    )
    packed = pack_scene(scene, tri_block=128)
    o = jnp.asarray([[0.2, 0.2, 5.0], [0.2, 0.2, -5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    h = intersect_pallas(o, d, packed, ray_tile=256, interpret=True)
    assert bool(h.hit[0]) and bool(h.hit[1])
    assert int(h.tri[0]) == 0 and int(h.tri[1]) == 0  # mapped back
    np.testing.assert_allclose(np.asarray(h.t), [5.0, 5.0], rtol=1e-5)


def test_pallas_cull_mask_conservative():
    """Culled (tile, block) pairs must never contain a real hit."""
    from gpupathtracer_tpu.ops.pallas_intersect import tile_block_mask

    scene, o, d = random_scene(seed=3)
    packed = pack_scene(scene, tri_block=128)
    ray_tile = 256
    pad = (-o.shape[0]) % ray_tile
    o2 = jnp.pad(o, ((0, pad), (0, 0)))
    d2 = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    mask, _enter = tile_block_mask(o2, d2, packed, ray_tile)
    mask = np.asarray(mask)
    h = intersect_pallas(o, d, packed, ray_tile=ray_tile, interpret=True)
    h_ref = intersect_plucker_jnp(o, d, pack_triangles(scene, tri_block=128))
    agree = np.asarray(h.tri) == np.asarray(h_ref.tri)
    assert agree.mean() > 0.999
    # Incoherent tiles (directions straddle 0 per axis) conservatively test
    # everything — that's correct, not a failure.
    assert mask.min() >= 0 and mask.max() <= 1

    # Coherent rays aimed AWAY from the scene must cull every block.
    r = 512
    o_away = jnp.tile(jnp.asarray([[0.0, 0.0, 50.0]], jnp.float32), (r, 1))
    d_away = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (r, 1))
    mask_away, _ = tile_block_mask(o_away, d_away, packed, ray_tile)
    mask_away = np.asarray(mask_away)
    assert mask_away.sum() == 0
    h_away = intersect_pallas(o_away, d_away, packed, ray_tile=ray_tile, interpret=True)
    assert not np.asarray(h_away.hit).any()

    # Coherent rays aimed AT the scene still find the same hits as the oracle.
    o_at = jnp.tile(jnp.asarray([[0.0, 0.0, 50.0]], jnp.float32), (r, 1))
    dirs = np.zeros((r, 3), np.float32)
    dirs[:, 0] = np.linspace(-0.1, 0.1, r)
    dirs[:, 2] = -1.0
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d_at = jnp.asarray(dirs)
    h_at = intersect_pallas(o_at, d_at, packed, ray_tile=ray_tile, interpret=True)
    h_at_ref = intersect_plucker_jnp(o_at, d_at, pack_triangles(scene, tri_block=128))
    assert (np.asarray(h_at.tri) == np.asarray(h_at_ref.tri)).mean() > 0.999


def test_two_sided_and_cull_semantics_plucker():
    """One-sided backface cull + two-sided acceptance survive the Plücker path."""
    tri = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    mesh = MeshData(
        vertices=tri, normals=np.zeros((1, 3, 3), np.float32), uvs=np.zeros((1, 3, 2), np.float32)
    )
    for two_sided, expect_back in [(False, False), (True, True)]:
        scene = build_scene(
            [mesh_spec(mesh, two_sided=two_sided)], [{"type": "diffuse"}], pad_to_multiple=128
        )
        packed = pack_triangles(scene, tri_block=128)
        o = jnp.asarray([[0.2, 0.2, 5.0], [0.2, 0.2, -5.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
        h = intersect_plucker_jnp(o, d, packed)
        assert bool(h.hit[0])  # front always hits
        assert bool(h.hit[1]) == expect_back
        np.testing.assert_allclose(float(h.t[0]), 5.0, rtol=1e-5)


def test_render_frame_with_plucker_backend_matches_brute():
    from gpupathtracer_tpu.models.camera import Camera
    from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame

    scene = build_scene(
        [
            mesh_spec(triangle_mesh(), mat_id=0),
            plane_spec((0.5, 0.5, -1.5), (0, 0, 0), (8, 8, 8), mat_id=1),
        ],
        [
            {"type": "diffuse", "albedo": (1.0, 0.0, 0.0)},
            {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
        ],
        pad_to_multiple=128,
    )
    cam = Camera.create(position=(0.5, 0.5, 3.0), width=32, height=32)
    base = dict(width=32, height=32, spp=2, bounces=2, tri_block=128)
    img_brute = np.asarray(render_frame(scene, cam, RenderSettings(**base, intersector="brute")))
    img_pl = np.asarray(render_frame(scene, cam, RenderSettings(**base, intersector="plucker")))
    img_pa = np.asarray(render_frame(scene, cam, RenderSettings(**base, intersector="pallas")))
    np.testing.assert_allclose(img_pl, img_brute, atol=1e-5)
    np.testing.assert_allclose(img_pa, img_pl, atol=1e-6)
