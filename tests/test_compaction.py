"""Dead-lane compaction: stable partition correctness and estimator
invariance (compaction must not change a single sample)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.models.camera import Camera
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.ops.compaction import (
    compact_rays,
    compact_rays_coherent,
    partition_alive,
)
from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame
from meshes import cube_mesh, triangle_mesh


def test_partition_alive_stable():
    alive = jnp.asarray([True, False, True, True, False, False, True, False])
    perm, inv = partition_alive(alive)
    perm = np.asarray(perm)
    # Live lanes first, original order preserved within classes.
    assert perm.tolist() == [0, 2, 3, 6, 1, 4, 5, 7]
    x = jnp.arange(8)
    packed = x[jnp.asarray(perm)]
    restored = packed[inv]
    np.testing.assert_array_equal(np.asarray(restored), np.asarray(x))


def test_compact_rays_roundtrip():
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.normal(size=(16, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(16, 3)), jnp.float32)
    alive = jnp.asarray(rng.random(16) > 0.5)
    o_c, d_c, inv = compact_rays(o, d, alive)
    o_back = o_c[inv]
    # Live lanes restore exactly; dead lanes are parked.
    np.testing.assert_allclose(
        np.asarray(o_back)[np.asarray(alive)], np.asarray(o)[np.asarray(alive)]
    )
    assert (np.asarray(o_c)[np.asarray(alive[np.asarray(partition_alive(alive)[0])]) == False] > 1e6).all()


def test_compact_rays_coherent_roundtrip():
    """Coherent compaction: live lanes restore exactly, dead lanes park,
    live lanes are grouped dead-last and by direction octant."""
    rng = np.random.default_rng(1)
    o = jnp.asarray(rng.normal(size=(64, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(64, 3)), jnp.float32)
    alive = jnp.asarray(rng.random(64) > 0.4)
    o_c, d_c, inv = compact_rays_coherent(o, d, alive)
    np.testing.assert_array_equal(
        np.asarray(o_c[inv])[np.asarray(alive)], np.asarray(o)[np.asarray(alive)]
    )
    np.testing.assert_array_equal(
        np.asarray(d_c[inv])[np.asarray(alive)], np.asarray(d)[np.asarray(alive)]
    )
    n_alive = int(np.asarray(alive).sum())
    # Live lanes occupy the prefix (dead keys sort last)...
    assert (np.asarray(o_c)[:n_alive] < 1e6).all()
    assert (np.asarray(o_c)[n_alive:] > 1e6).all()
    # ...and within the live prefix, direction octants are contiguous.
    sgn = np.sign(np.asarray(d_c)[:n_alive]) < 0
    oct_ids = sgn[:, 0] * 1 + sgn[:, 1] * 2 + sgn[:, 2] * 4
    changes = int(np.sum(oct_ids[1:] != oct_ids[:-1]))
    assert changes <= len(np.unique(oct_ids)) - 1 + 0  # each octant appears once


def test_render_invariant_under_compaction():
    scene = build_scene(
        [
            mesh_spec(triangle_mesh(), mat_id=0),
            plane_spec((0.5, 0.5, -1.5), (0, 0, 0), (4, 4, 4), mat_id=1),
        ],
        [
            {"type": "diffuse", "albedo": (1.0, 0.0, 0.0)},
            {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
        ],
        pad_to_multiple=128,
    )
    cam = Camera.create(position=(0.5, 0.5, 3.0), width=24, height=24)
    base = dict(
        width=24, height=24, spp=2, bounces=3, tri_block=128,
        intersector="pallas", estimator="nee",
    )
    img_on = np.asarray(render_frame(scene, cam, RenderSettings(**base, compact=True)))
    img_off = np.asarray(render_frame(scene, cam, RenderSettings(**base, compact=False)))
    np.testing.assert_array_equal(img_on, img_off)


def test_mask_compaction_matches_oracle_and_permute():
    """Mask-based compaction (alive → kernel frustum pre-pass): live lanes
    match the brute oracle, dead lanes report no hit, and a full render is
    identical across compact_mode="mask" / "permute" / compact=False."""
    from gpupathtracer_tpu.ops import pallas_intersect as pi
    from gpupathtracer_tpu.ops.intersect import intersect_brute

    scene = build_scene(
        [
            mesh_spec(cube_mesh(), mat_id=0),
            plane_spec((0.0, 0.0, -2.0), (0, 0, 0), (6, 6, 6), mat_id=1),
        ],
        [
            {"type": "diffuse", "albedo": (0.7, 0.3, 0.2)},
            {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
        ],
        pad_to_multiple=128,
    )
    packed = pi.pack_scene(scene, tri_block=128)
    cam = Camera.create(position=(0.0, 0.0, 5.0), width=32, height=32)
    from gpupathtracer_tpu.models.camera import generate_rays

    o, d = generate_rays(cam)
    rng = np.random.default_rng(5)
    alive = jnp.asarray(rng.random(o.shape[0]) < 0.35)

    h_ref = intersect_brute(o, d, scene, tri_block=128)
    h = pi.intersect_pallas(o, d, packed, interpret=True, alive=alive)
    a = np.asarray(alive)
    np.testing.assert_array_equal(np.asarray(h.tri)[a], np.asarray(h_ref.tri)[a])
    assert (~np.asarray(h.hit)[~a]).all()
    assert (np.asarray(h.tri)[~a] == -1).all()

    base = dict(
        width=32, height=32, spp=2, bounces=3, tri_block=128,
        intersector="pallas", estimator="nee",
    )
    imgs = [
        np.asarray(render_frame(scene, cam, RenderSettings(**base, **kw)))
        for kw in (
            dict(compact=True, compact_mode="mask"),
            dict(compact=True, compact_mode="permute"),
            dict(compact=True, compact_mode="hybrid"),
            dict(compact=False),
        )
    ]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    np.testing.assert_array_equal(imgs[0], imgs[2])
    np.testing.assert_array_equal(imgs[0], imgs[3])


def test_compact_rays_coherent_origin_key():
    """"origin" key mode: same roundtrip contract; live lanes are octant-
    pure within each contiguous run (octant is the top field)."""
    rng = np.random.default_rng(5)
    o = jnp.asarray(rng.normal(size=(64, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(64, 3)), jnp.float32)
    alive = jnp.asarray(rng.random(64) > 0.4)
    o_c, d_c, inv = compact_rays_coherent(o, d, alive, key_mode="origin")
    np.testing.assert_array_equal(
        np.asarray(o_c[inv])[np.asarray(alive)], np.asarray(o)[np.asarray(alive)]
    )
    n_alive = int(np.asarray(alive).sum())
    assert (np.asarray(o_c)[:n_alive] < 1e6).all()
    assert (np.asarray(o_c)[n_alive:] > 1e6).all()
    sgn = np.sign(np.asarray(d_c)[:n_alive]) < 0
    oct_ids = sgn[:, 0] * 1 + sgn[:, 1] * 2 + sgn[:, 2] * 4
    changes = int(np.sum(oct_ids[1:] != oct_ids[:-1]))
    assert changes <= len(np.unique(oct_ids)) - 1


def test_render_invariant_under_sort_key():
    """Images are bit-identical across sort off / dir key / origin key —
    per-lane results don't depend on lane order."""
    scene = build_scene(
        [
            mesh_spec(triangle_mesh(), mat_id=0),
            plane_spec((0.5, 0.5, -1.5), (0, 0, 0), (4, 4, 4), mat_id=1),
        ],
        [
            {"type": "diffuse", "albedo": (1.0, 0.0, 0.0)},
            {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
        ],
        pad_to_multiple=128,
    )
    cam = Camera.create(position=(0.5, 0.5, 3.0), width=24, height=24)
    base = dict(
        width=24, height=24, spp=2, bounces=3, tri_block=128,
        intersector="pallas", estimator="nee",
    )
    img_off = np.asarray(render_frame(scene, cam, RenderSettings(**base, sort_rays=False)))
    img_dir = np.asarray(
        render_frame(scene, cam, RenderSettings(**base, sort_rays=True, sort_key="dir"))
    )
    img_origin = np.asarray(
        render_frame(scene, cam, RenderSettings(**base, sort_rays=True, sort_key="origin"))
    )
    np.testing.assert_array_equal(img_off, img_dir)
    np.testing.assert_array_equal(img_off, img_origin)


@pytest.mark.parametrize("estimator", ["naive", "nee"])
def test_render_invariant_under_kernel_block_width(estimator, monkeypatch):
    """The kernel's triangle block width changes tiling only: packed row
    order is Morton (block-width-independent) and min/argmin ties resolve
    first-in-order within and across blocks, so images are bit-identical
    across widths — for both estimators (the any-hit query packs too)."""
    from gpupathtracer_tpu.ops import pallas_intersect as pi

    scene = build_scene(
        [
            mesh_spec(triangle_mesh(), mat_id=0),
            plane_spec((0.5, 0.5, -1.5), (0, 0, 0), (4, 4, 4), mat_id=1),
        ],
        [
            {"type": "diffuse", "albedo": (1.0, 0.0, 0.0)},
            {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
        ],
        pad_to_multiple=128,
    )
    cam = Camera.create(position=(0.5, 0.5, 3.0), width=24, height=24)
    settings = RenderSettings(
        width=24, height=24, spp=2, bounces=3, tri_block=128,
        intersector="pallas", estimator=estimator,
    )
    imgs = []
    for tb in (16, 64):
        monkeypatch.setattr(pi, "TRI_BLOCK", tb)
        imgs.append(np.asarray(render_frame(scene, cam, settings)))
    np.testing.assert_array_equal(imgs[0], imgs[1])
