"""BVH: structural invariants (every valid triangle reachable exactly once)
and hit parity with the brute-force oracle (SURVEY.md §4.1)."""

import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.accel.bvh import Bvh, build_bvh, intersect_bvh
from gpupathtracer_tpu.models.obj import MeshData
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.ops.intersect import intersect_brute
from meshes import cube_mesh, triangle_mesh


def random_scene(seed=0, n=300):
    rng = np.random.default_rng(seed)
    tris = rng.normal(size=(n, 3, 3)).astype(np.float32) * 2
    mesh = MeshData(
        vertices=tris, normals=np.zeros((n, 3, 3), np.float32), uvs=np.zeros((n, 3, 2), np.float32)
    )
    scene = build_scene(
        [mesh_spec(mesh), plane_spec((0, 0, 0), (15, 25, 0), (3, 3, 3))],
        [{"type": "diffuse"}],
        pad_to_multiple=128,
    )
    r = 600
    o = jnp.asarray(rng.normal(size=(r, 3)) * 4, jnp.float32)
    draw = rng.normal(size=(r, 3)).astype(np.float32)
    d = jnp.asarray(draw / np.linalg.norm(draw, axis=1, keepdims=True))
    return scene, o, d


def test_every_valid_triangle_reachable_once():
    scene, _, _ = random_scene()
    bvh = build_bvh(scene, leaf_size=8)
    order = np.asarray(bvh.tri_order)
    real = order[order >= 0]
    valid_rows = np.where(np.asarray(scene.valid))[0]
    assert sorted(real.tolist()) == sorted(valid_rows.tolist())


def test_leaf_slots_covered_by_nodes():
    scene, _, _ = random_scene(seed=1)
    bvh = build_bvh(scene, leaf_size=4)
    first = np.asarray(bvh.first)
    count = np.asarray(bvh.count)
    leaves = count > 0
    spans = [(int(f), int(f + c)) for f, c in zip(first[leaves], count[leaves])]
    spans.sort()
    # Leaf spans tile [0, num_real_slots) without overlap.
    pos = 0
    for a, b in spans:
        assert a == pos
        pos = b
    real = np.asarray(bvh.tri_order) >= 0
    assert pos == int(real.sum())


def test_escape_links_monotone():
    scene, _, _ = random_scene(seed=2)
    bvh = build_bvh(scene)
    miss = np.asarray(bvh.miss)
    m = bvh.num_nodes
    assert (miss > np.arange(m)).all() and (miss <= m).all()


@pytest.mark.parametrize("leaf_size", [4, 8, 16])
def test_bvh_matches_brute(leaf_size):
    scene, o, d = random_scene(seed=3)
    bvh = build_bvh(scene, leaf_size=leaf_size)
    h_ref = intersect_brute(o, d, scene, tri_block=128)
    h_bvh = intersect_bvh(o, d, scene, bvh)
    np.testing.assert_array_equal(np.asarray(h_bvh.hit), np.asarray(h_ref.hit))
    hits = np.asarray(h_ref.hit)
    np.testing.assert_allclose(
        np.asarray(h_bvh.t)[hits], np.asarray(h_ref.t)[hits], rtol=1e-5, atol=1e-5
    )
    # Winning triangle matches wherever the winner is unique (ties may
    # resolve in traversal order rather than scene order).
    agree = (np.asarray(h_bvh.tri) == np.asarray(h_ref.tri))[hits]
    assert agree.mean() > 0.995


def test_bvh_two_sided_plane():
    scene = build_scene(
        [plane_spec((0, 0, 0), (0, 0, 0), (5, 5, 5))], [{"type": "diffuse"}], pad_to_multiple=8
    )
    bvh = build_bvh(scene, leaf_size=4)
    o = jnp.asarray([[0.0, 0.0, 5.0], [0.0, 0.0, -5.0], [2.6, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    h = intersect_bvh(o, d, scene, bvh)
    assert np.asarray(h.hit).tolist() == [True, True, False]
    np.testing.assert_allclose(np.asarray(h.t[:2]), [5.0, 5.0], rtol=1e-5)


def test_bvh_in_integrator():
    from functools import partial

    import jax

    from gpupathtracer_tpu.render.integrator import IntegratorOptions, trace_paths

    scene = build_scene(
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
    bvh = build_bvh(scene)
    o = jnp.asarray([[0.5, 0.5, 3.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    from gpupathtracer_tpu.ops import sampling

    opts = IntegratorOptions(bounces=2, tri_block=8)
    keys = sampling.path_keys(0, jnp.arange(1, dtype=jnp.uint32), impl=opts.rng)
    rad_ref = trace_paths(scene, o, d, keys, opts)
    rad_bvh = trace_paths(
        scene, o, d, keys, opts, intersect_fn=lambda oo, dd, s: intersect_bvh(oo, dd, s, bvh)
    )
    np.testing.assert_allclose(np.asarray(rad_bvh), np.asarray(rad_ref), atol=1e-6)


def test_bvh_via_render_settings():
    """intersector="bvh" plumbed through RenderSettings: the BVH is built
    host-side and passed into the jitted core; frame equals the brute path."""
    from gpupathtracer_tpu.models.camera import Camera
    from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame

    scene = build_scene(
        [
            mesh_spec(cube_mesh(), mat_id=0),
            plane_spec((0.0, 0.0, -2.5), (0, 0, 0), (8, 8, 8), mat_id=1),
        ],
        [
            {"type": "diffuse", "albedo": (0.4, 0.6, 0.8)},
            {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
        ],
        pad_to_multiple=8,
    )
    cam = Camera.create(position=(0.0, 0.0, 4.0), width=24, height=24)
    base = dict(width=24, height=24, spp=2, bounces=2, tri_block=8)
    img_bvh = np.asarray(render_frame(scene, cam, RenderSettings(**base, intersector="bvh")))
    img_ref = np.asarray(render_frame(scene, cam, RenderSettings(**base, intersector="brute")))
    np.testing.assert_allclose(img_bvh, img_ref, atol=1e-6)
