"""Large-scene coverage: subdivision correctness, and kernel parity vs the
Möller–Trumbore oracle on an 82k-triangle scene (many blocks to cull and
order front to back)."""

import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.models.obj import subdivide_mesh
from gpupathtracer_tpu.models.scene import build_scene, icosphere, mesh_spec
from gpupathtracer_tpu.ops.intersect import intersect_brute
from gpupathtracer_tpu.ops.pallas_intersect import intersect_pallas, pack_scene
from meshes import cube_mesh


def _big_mesh():
    return subdivide_mesh(icosphere(4), 2)  # 81,920 tris


def test_subdivide_preserves_surface():
    mesh = cube_mesh()
    sub = subdivide_mesh(mesh, 2)
    assert sub.num_triangles == mesh.num_triangles * 16
    # Same surface: total area unchanged; bounding box unchanged.
    def area(m):
        e1 = m.vertices[:, 1] - m.vertices[:, 0]
        e2 = m.vertices[:, 2] - m.vertices[:, 0]
        return np.linalg.norm(np.cross(e1, e2), axis=-1).sum() / 2

    np.testing.assert_allclose(area(sub), area(mesh), rtol=1e-5)
    np.testing.assert_allclose(
        sub.vertices.reshape(-1, 3).min(0), mesh.vertices.reshape(-1, 3).min(0), atol=1e-6
    )
    np.testing.assert_allclose(
        sub.vertices.reshape(-1, 3).max(0), mesh.vertices.reshape(-1, 3).max(0), atol=1e-6
    )
    # Unit normals survive interpolation.
    np.testing.assert_allclose(
        np.linalg.norm(sub.normals, axis=-1), 1.0, atol=1e-5
    )


def test_subdivided_render_matches_base():
    """Subdivision leaves the surface unchanged ⇒ the closest-hit t field is
    identical (up to fp) for rays hitting the interior of original tris."""
    mesh = cube_mesh()
    base = build_scene([mesh_spec(mesh)], [{"type": "diffuse"}], pad_to_multiple=8)
    sub = build_scene(
        [mesh_spec(subdivide_mesh(mesh, 2))], [{"type": "diffuse"}], pad_to_multiple=8
    )
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.normal(size=(400, 3)) * 4, jnp.float32)
    draw = rng.normal(size=(400, 3)).astype(np.float32)
    d = jnp.asarray(draw / np.linalg.norm(draw, axis=1, keepdims=True))
    h_base = intersect_brute(o, d, base, tri_block=8)
    h_sub = intersect_brute(o, d, sub, tri_block=8)
    np.testing.assert_array_equal(np.asarray(h_base.hit), np.asarray(h_sub.hit))
    hits = np.asarray(h_base.hit)
    np.testing.assert_allclose(
        np.asarray(h_sub.t)[hits], np.asarray(h_base.t)[hits], rtol=2e-5, atol=2e-5
    )


@pytest.mark.slow
def test_kernel_parity_large_scene():
    """Kernel vs the oracle on 164k triangles (two subdivided icospheres)
    with camera-coherent rays."""
    mesh = _big_mesh()
    scene = build_scene(
        [
            mesh_spec(mesh, position=(-4.0, -2.0, 0.0), scale=(1.5, 1.5, 1.5)),
            mesh_spec(mesh, position=(4.0, -2.0, 0.0), scale=(1.5, 1.5, 1.5)),
        ],
        [{"type": "diffuse"}],
        pad_to_multiple=512,
    )
    assert scene.num_triangles >= 100_000
    packed = pack_scene(scene, tri_block=512)

    # Camera-like coherent bundle: one origin, directions at random points
    # inside the instanced meshes' bounding box (guaranteed mostly-hit).
    r = 512
    rng = np.random.default_rng(3)
    o = jnp.tile(jnp.asarray([[0.0, 1.0, 12.0]], jnp.float32), (r, 1))
    verts = np.asarray(scene.v0)[np.asarray(scene.valid)]
    lo, hi = verts.min(0), verts.max(0)
    targets = rng.uniform(lo, hi, size=(r, 3)).astype(np.float32)
    dirs = targets - np.asarray(o)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d = jnp.asarray(dirs)

    h = intersect_pallas(o, d, packed, ray_tile=128, interpret=True)
    h_ref = intersect_brute(o, d, scene, tri_block=512)

    agree = np.asarray(h.tri) == np.asarray(h_ref.tri)
    assert np.asarray(h_ref.hit).mean() > 0.25  # the bundle actually hits
    assert agree.mean() > 0.999
    same = agree & np.asarray(h_ref.hit)
    np.testing.assert_allclose(
        np.asarray(h.t)[same], np.asarray(h_ref.t)[same], rtol=1e-4, atol=1e-4
    )


@pytest.mark.slow
def test_kernel_occlusion_parity_large_scene():
    """Any-hit mode vs thresholded brute-force closest hit on 82k triangles —
    same predicate, so exact agreement is required; max_t = 0 lanes must
    report unoccluded."""
    from gpupathtracer_tpu.ops.pallas_intersect import intersect_pallas_occluded

    scene = build_scene(
        [mesh_spec(_big_mesh(), position=(0.0, -2.0, 0.0), scale=(1.5, 1.5, 1.5))],
        [{"type": "diffuse"}],
        pad_to_multiple=512,
    )
    packed = pack_scene(scene, tri_block=512)

    r = 512
    rng = np.random.default_rng(7)
    o = jnp.tile(jnp.asarray([[0.0, 1.0, 12.0]], jnp.float32), (r, 1))
    verts = np.asarray(scene.v0)[np.asarray(scene.valid)]
    lo, hi = verts.min(0), verts.max(0)
    targets = rng.uniform(lo, hi, size=(r, 3)).astype(np.float32)
    dirs = targets - np.asarray(o)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d = jnp.asarray(dirs)

    h_ref = intersect_brute(o, d, scene, tri_block=512)
    # Cutoffs straddling the true hit distances; every 5th lane dead (0).
    cut = np.where(
        rng.uniform(size=r) < 0.5, np.asarray(h_ref.t) * 0.9, np.asarray(h_ref.t) * 1.1
    ).astype(np.float32)
    cut = np.where(np.isfinite(cut) & (cut < 1e30), cut, 20.0)
    cut[::5] = 0.0
    max_t = jnp.asarray(cut)

    occ = intersect_pallas_occluded(o, d, max_t, packed, ray_tile=128, interpret=True)
    want = np.asarray(h_ref.hit) & (np.asarray(h_ref.t) < cut)
    np.testing.assert_array_equal(np.asarray(occ), want)
