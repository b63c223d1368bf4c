"""Silhouette/visibility gradients (grad/edges.py — SURVEY.md §7.3 crux):
edge-table construction, silhouette classification, FD validation of the
boundary term on silhouette-dominated scenes, and a recovery task that
detached sampling provably cannot solve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.grad.edges import (
    build_edge_table,
    primary_edge_gradient,
    silhouette_flags,
    screen_xy,
    value_and_grad_with_edges,
)
from gpupathtracer_tpu.models.camera import Camera, generate_rays_for_pixels
from gpupathtracer_tpu.models.obj import MeshData
from gpupathtracer_tpu.models.scene import GeometrySpec, build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame
from meshes import cube_mesh

EMITTER = {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0}
BLACK = {"type": "diffuse", "albedo": (0.0, 0.0, 0.0)}

QUAD = np.asarray(
    [
        [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0]],
        [[-0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]],
    ],
    np.float32,
)  # CCW, +z normal (faces a +z camera)


def quad_mesh(verts=QUAD):
    return MeshData(
        vertices=np.asarray(verts, np.float32),
        normals=np.broadcast_to(np.asarray([0, 0, 1], np.float32), (2, 3, 3)).copy(),
        uvs=np.zeros((2, 3, 2), np.float32),
    )


def test_edge_table_cube():
    scene = build_scene(
        [mesh_spec(cube_mesh())],
        [BLACK],
        pad_to_multiple=8,
    )
    table = build_edge_table(scene)
    # Closed 12-tri cube: E = 3T/2 = 18 unique edges, all manifold.
    assert table.num_edges == 18
    assert (table.tri2 >= 0).all()


def test_silhouette_classification_cube():
    scene = build_scene(
        [mesh_spec(cube_mesh())],
        [BLACK],
        pad_to_multiple=8,
    )
    table = build_edge_table(scene)
    # Generic viewpoint: 3 visible faces -> hexagonal outline = 6 edges.
    sil, interior = silhouette_flags(scene, table, jnp.asarray([4.0, 3.0, 5.0]))
    assert int(jnp.sum(sil)) == 6
    # The interior triangle must be front-facing for every silhouette edge.
    vp = jnp.asarray([4.0, 3.0, 5.0])
    front = jnp.sum(scene.gn[interior] * (vp[None] - scene.v0[interior]), axis=-1) > 0
    assert bool(jnp.all(jnp.where(sil, front, True)))


def test_screen_projection_roundtrip():
    """A ray generated for screen coordinate (x, y) re-projects to (x, y)."""
    cam = Camera.create(position=(0.3, -0.2, 4.0), fov_deg=50.0, width=64, height=48)
    xy = jnp.asarray([[10.5, 20.25], [3.0, 40.0], [60.9, 5.5]], jnp.float32)
    o, d = generate_rays_for_pixels(cam, jnp.zeros((3,), jnp.uint32), xy)
    pts = o + 3.7 * d  # arbitrary points along the rays
    back = screen_xy(cam, pts)
    np.testing.assert_allclose(np.asarray(back), np.asarray(xy), rtol=1e-4, atol=1e-3)


def _quad_scene_fn(s):
    """Black quad occluder (scaled by s) in front of a big emitter backdrop."""
    spec = GeometrySpec(
        vertices=jnp.asarray(QUAD) * s,
        normals=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (2, 3, 3)),
        uvs=jnp.zeros((2, 3, 2)),
        position=jnp.zeros(3),
        rotation_deg=jnp.zeros(3),
        scale=jnp.ones(3),
        mat_id=0,
    )
    backdrop = plane_spec((0.0, 0.0, -2.0), (0.0, 0.0, 0.0), (40.0, 40.0, 40.0), mat_id=1)
    return build_scene([spec, backdrop], [BLACK, EMITTER], pad_to_multiple=8)


QUAD_CAM = Camera.create(position=(0.0, 0.0, 4.0), fov_deg=45.0, width=64, height=64)
QUAD_SETTINGS = RenderSettings(
    width=64, height=64, spp=16, bounces=1, tri_block=8,
    estimator="naive", intersector="brute", jitter=True,
)


def test_quad_scale_gradient_fd():
    """THE silhouette FD test (VERDICT item 1 acceptance): a black occluder
    against a uniform emitter — the interior (detached) gradient is exactly
    zero, the FD is pure boundary motion, and the edge-sampled estimator
    must match it."""

    def image_loss(img):
        return jnp.mean(img)

    def loss(s):
        return image_loss(render_frame(_quad_scene_fn(s), QUAD_CAM, QUAD_SETTINGS))

    # Detached sampling provably yields zero for the black occluder.
    g_detached = float(jax.grad(loss)(jnp.float32(1.0)))
    assert abs(g_detached) < 1e-7

    table = build_edge_table(_quad_scene_fn(jnp.float32(1.0)))
    _, g_total = value_and_grad_with_edges(
        image_loss, _quad_scene_fn, jnp.float32(1.0), QUAD_CAM, QUAD_SETTINGS,
        table, jax.random.PRNGKey(7), n_samples=2048, trace_spp=2,
    )
    g_total = float(g_total)

    h = 0.05
    fd = (float(loss(jnp.float32(1.0 + h))) - float(loss(jnp.float32(1.0 - h)))) / (2 * h)

    # Growing the black quad dims the image.
    assert fd < 0 and g_total < 0
    np.testing.assert_allclose(g_total, fd, rtol=0.15)


def test_sphere_scale_gradient_fd():
    """Curved silhouette (icosphere ring of edges) against the emitter
    backdrop — exercises categorical edge sampling over many short edges."""
    from gpupathtracer_tpu.models.scene import icosphere

    sphere = icosphere(2)

    def scene_fn(s):
        spec = GeometrySpec(
            vertices=jnp.asarray(sphere.vertices) * s,
            normals=jnp.asarray(sphere.normals),
            uvs=jnp.asarray(sphere.uvs),
            position=jnp.zeros(3),
            rotation_deg=jnp.zeros(3),
            scale=jnp.ones(3),
            mat_id=0,
        )
        backdrop = plane_spec((0.0, 0.0, -2.0), (0.0, 0.0, 0.0), (40.0, 40.0, 40.0), mat_id=1)
        return build_scene([spec, backdrop], [BLACK, EMITTER], pad_to_multiple=8)

    def image_loss(img):
        return jnp.mean(img)

    def loss(s):
        return image_loss(render_frame(scene_fn(s), QUAD_CAM, QUAD_SETTINGS))

    table = build_edge_table(scene_fn(jnp.float32(1.0)))
    _, g_total = value_and_grad_with_edges(
        image_loss, scene_fn, jnp.float32(1.0), QUAD_CAM, QUAD_SETTINGS,
        table, jax.random.PRNGKey(11), n_samples=4096, trace_spp=2,
    )
    g_total = float(g_total)

    h = 0.05
    fd = (float(loss(jnp.float32(1.0 + h))) - float(loss(jnp.float32(1.0 - h)))) / (2 * h)
    assert fd < 0 and g_total < 0
    np.testing.assert_allclose(g_total, fd, rtol=0.2)


def test_shadow_edge_gradient_fd():
    """NEE shadow-boundary FD (SURVEY §7.3's second visibility term): a
    black occluder OUTSIDE the camera frustum shades a lit floor; the only
    θ-dependence of the image is the shadow silhouette sweeping the floor —
    interior and primary-edge terms are both ~0, FD is pure shadow motion."""
    from gpupathtracer_tpu.grad.edges import shadow_edge_gradient

    GREY = {"type": "diffuse", "albedo": (0.6, 0.6, 0.6)}

    def scene_fn(s):
        # Occluder quad at y=1.5, horizontal (normal +y→ rotated), scaled s.
        occ = GeometrySpec(
            vertices=jnp.asarray(QUAD) * s,
            normals=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (2, 3, 3)),
            uvs=jnp.zeros((2, 3, 2)),
            position=jnp.asarray([0.0, 1.5, 0.0]),
            rotation_deg=jnp.asarray([90.0, 0.0, 0.0]),
            scale=jnp.ones(3),
            mat_id=2,
            two_sided=True,
        )
        floor = plane_spec((0.0, 0.0, 0.0), (90.0, 0.0, 0.0), (6.0, 6.0, 6.0), mat_id=0)
        light = plane_spec((0.0, 3.0, 0.0), (90.0, 0.0, 0.0), (1.5, 1.5, 1.5), mat_id=1)
        return build_scene(
            [floor, light, occ],
            [GREY, {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 6.0}, BLACK],
            pad_to_multiple=8,
        )

    # Camera low, pitched down at the floor: the occluder (y=1.5) and light
    # (y=3) are above the frustum — no primary silhouettes of either.
    cam = Camera.create(
        position=(0.0, 1.0, 4.5), pitch=-25.0, fov_deg=35.0, width=48, height=48
    )
    settings = RenderSettings(
        width=48, height=48, spp=16, bounces=2, tri_block=8,
        estimator="nee", intersector="brute", jitter=True,
    )

    def image_loss(img):
        return jnp.mean(img)

    def loss(s):
        return float(image_loss(render_frame(scene_fn(s), cam, settings)))

    # Interior (detached) gradient misses the shadow sweep entirely.
    g_detached = float(
        jax.grad(lambda s: image_loss(render_frame(scene_fn(s), cam, settings)))(jnp.float32(1.0))
    )

    table = build_edge_table(scene_fn(jnp.float32(1.0)))
    cot = jax.grad(image_loss)(render_frame(scene_fn(jnp.float32(1.0)), cam, settings))
    g_shadow = float(
        shadow_edge_gradient(
            scene_fn, jnp.float32(1.0), cam, settings, cot, table,
            jax.random.PRNGKey(13), n_samples=4096,
        )
    )

    h = 0.1
    fd = (loss(1.0 + h) - loss(1.0 - h)) / (2 * h)
    assert fd < 0  # growing the blocker darkens the floor
    # The shadow term IS the gradient here; detached is an order smaller.
    assert abs(g_detached) < 0.25 * abs(fd)
    np.testing.assert_allclose(g_shadow + g_detached, fd, rtol=0.25)


@pytest.mark.slow
def test_silhouette_recovery_beats_detached():
    """Config-5 variant (VERDICT item 1 'done' bar): recover the occluder's
    scale from a target image. Detached sampling is provably stuck (zero
    gradient); the edge-augmented gradient converges."""
    import optax

    true_s = 0.72
    target = jax.lax.stop_gradient(
        render_frame(_quad_scene_fn(jnp.float32(true_s)), QUAD_CAM, QUAD_SETTINGS)
    )

    def image_loss(img):
        return jnp.mean((img - target) ** 2)

    table = build_edge_table(_quad_scene_fn(jnp.float32(1.0)))
    s = jnp.float32(1.1)
    opt = optax.adam(3e-2)
    state = opt.init(s)
    key = jax.random.PRNGKey(3)
    losses = []
    for i in range(40):
        key, k = jax.random.split(key)
        loss, g = value_and_grad_with_edges(
            image_loss, _quad_scene_fn, s, QUAD_CAM, QUAD_SETTINGS,
            table, k, n_samples=1024, trace_spp=2,
        )
        upd, state = opt.update(g, state, s)
        s = optax.apply_updates(s, upd)
        losses.append(float(loss))
    assert abs(float(s) - true_s) < 0.05, (float(s), losses[::8])
    assert losses[-1] < losses[0] * 0.2


def test_edge_clusters_cover_all_edges():
    from gpupathtracer_tpu.grad.edges import build_edge_clusters
    from gpupathtracer_tpu.models.scene import icosphere

    sphere = icosphere(3)
    scene = build_scene([mesh_spec(sphere)], [BLACK], pad_to_multiple=8)
    table = build_edge_table(scene)
    clusters = build_edge_clusters(scene, table, cluster_size=64)
    ids = clusters.edge_ids[clusters.edge_ids >= 0]
    assert sorted(ids.tolist()) == list(range(table.num_edges))
    assert int(clusters.count.sum()) == table.num_edges
    # Conservative bounds really bound: every edge's adjacent-face plane
    # constant lies inside its cluster's [c_lo, c_hi].
    import numpy as np_

    gn = np_.asarray(scene.gn)
    v0 = np_.asarray(scene.v0)
    for ci in range(clusters.num_clusters):
        sel = clusters.edge_ids[ci][clusters.edge_ids[ci] >= 0]
        faces = np_.concatenate(
            [table.tri1[sel], table.tri2[sel][table.tri2[sel] >= 0]]
        )
        c = np_.einsum("fk,fk->f", gn[faces], v0[faces])
        assert c.min() >= clusters.c_lo[ci] - 1e-6
        assert c.max() <= clusters.c_hi[ci] + 1e-6
        assert (gn[faces].min(0) >= clusters.gn_lo[ci] - 1e-6).all()
        assert (gn[faces].max(0) <= clusters.gn_hi[ci] + 1e-6).all()


def test_shadow_edge_gradient_hierarchical_fd():
    """The cluster-hierarchy sampler is the same unbiased estimator as the
    flat path: rerun the shadow-FD scene with tiny forced clusters and
    assert the FD match (VERDICT r3 item 5)."""
    from gpupathtracer_tpu.grad.edges import build_edge_clusters, shadow_edge_gradient

    GREY = {"type": "diffuse", "albedo": (0.6, 0.6, 0.6)}

    def scene_fn(s):
        occ = GeometrySpec(
            vertices=jnp.asarray(QUAD) * s,
            normals=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (2, 3, 3)),
            uvs=jnp.zeros((2, 3, 2)),
            position=jnp.asarray([0.0, 1.5, 0.0]),
            rotation_deg=jnp.asarray([90.0, 0.0, 0.0]),
            scale=jnp.ones(3),
            mat_id=2,
            two_sided=True,
        )
        floor = plane_spec((0.0, 0.0, 0.0), (90.0, 0.0, 0.0), (6.0, 6.0, 6.0), mat_id=0)
        light = plane_spec((0.0, 3.0, 0.0), (90.0, 0.0, 0.0), (1.5, 1.5, 1.5), mat_id=1)
        return build_scene(
            [floor, light, occ],
            [GREY, {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 6.0}, BLACK],
            pad_to_multiple=8,
        )

    cam = Camera.create(
        position=(0.0, 1.0, 4.5), pitch=-25.0, fov_deg=35.0, width=48, height=48
    )
    settings = RenderSettings(
        width=48, height=48, spp=16, bounces=2, tri_block=8,
        estimator="nee", intersector="brute", jitter=True,
    )

    def image_loss(img):
        return jnp.mean(img)

    def loss(s):
        return float(image_loss(render_frame(scene_fn(s), cam, settings)))

    scene0 = scene_fn(jnp.float32(1.0))
    table = build_edge_table(scene0)
    clusters = build_edge_clusters(scene0, table, cluster_size=4)  # force multi-cluster
    assert clusters.num_clusters > 2
    cot = jax.grad(image_loss)(render_frame(scene0, cam, settings))
    g_shadow = float(
        shadow_edge_gradient(
            scene_fn, jnp.float32(1.0), cam, settings, cot, table,
            jax.random.PRNGKey(13), n_samples=4096, clusters=clusters,
        )
    )
    g_detached = float(
        jax.grad(lambda s: image_loss(render_frame(scene_fn(s), cam, settings)))(jnp.float32(1.0))
    )
    h = 0.1
    fd = (loss(1.0 + h) - loss(1.0 - h)) / (2 * h)
    assert fd < 0
    np.testing.assert_allclose(g_shadow + g_detached, fd, rtol=0.3)


@pytest.mark.slow
def test_primary_edge_gradient_fd_10k_edges():
    """FD-validated vertex (scale) gradient on a >10k-edge scene (VERDICT
    r3 item 5 'done' bar): icosphere(4) instanced twice = 15,360 edges of
    silhouette-rich geometry against an emitter backdrop."""
    from gpupathtracer_tpu.models.scene import icosphere

    sphere = icosphere(4)  # 5,120 tris, 7,680 edges per instance

    def scene_fn(s):
        def inst(px):
            return GeometrySpec(
                vertices=jnp.asarray(sphere.vertices) * s,
                normals=jnp.asarray(sphere.normals),
                uvs=jnp.asarray(sphere.uvs),
                position=jnp.asarray([px, 0.0, 0.0]),
                rotation_deg=jnp.zeros(3),
                scale=jnp.ones(3),
                mat_id=0,
            )

        backdrop = plane_spec((0.0, 0.0, -2.0), (0.0, 0.0, 0.0), (14.0, 10.0, 1.0), mat_id=1)
        return build_scene(
            [inst(-1.6), inst(1.6), backdrop], [BLACK, EMITTER], pad_to_multiple=128
        )

    cam = Camera.create(position=(0.0, 0.0, 6.0), fov_deg=45.0, width=48, height=48)
    settings = RenderSettings(
        width=48, height=48, spp=4, bounces=1, tri_block=128, jitter=True,
        intersector="plucker",
    )
    scene0 = scene_fn(jnp.float32(1.0))
    table = build_edge_table(scene0)
    assert table.num_edges >= 10_000

    def image_loss(img):
        return jnp.mean(img)

    def loss(s):
        return float(image_loss(render_frame(scene_fn(s), cam, settings)))

    cot = jax.grad(image_loss)(render_frame(scene0, cam, settings))
    g_edge = float(
        primary_edge_gradient(
            scene_fn, jnp.float32(1.0), cam, settings, cot, table,
            jax.random.PRNGKey(5), n_samples=4096, trace_spp=2,
        )
    )
    h = 0.05
    fd = (loss(1.0 + h) - loss(1.0 - h)) / (2 * h)
    # Growing black spheres covers more emitter: loss falls; the boundary
    # term carries essentially all of it (black-on-emitter silhouettes).
    assert fd < 0
    np.testing.assert_allclose(g_edge, fd, rtol=0.25)


def test_near_plane_edges_dropped_bias_bounded():
    """Edges crossing the near plane are excluded from the boundary term
    (grad/edges.py 'usable' mask — documented bias): on a scene whose ONLY
    silhouettes cross the camera plane, the boundary term is exactly 0."""
    def scene_fn(s):
        # A long wall passing THROUGH the camera plane toward the horizon.
        wall = GeometrySpec(
            vertices=jnp.asarray(QUAD) * s,
            normals=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (2, 3, 3)),
            uvs=jnp.zeros((2, 3, 2)),
            position=jnp.asarray([0.3, 0.0, 5.0]),
            rotation_deg=jnp.asarray([0.0, 90.0, 0.0]),
            scale=jnp.asarray([20.0, 1.0, 1.0]),  # spans z in front AND behind
            mat_id=0,
            two_sided=True,
        )
        return build_scene([wall], [BLACK], pad_to_multiple=8)

    cam = Camera.create(position=(0.0, 0.0, 5.0), fov_deg=60.0, width=16, height=16)
    settings = RenderSettings(width=16, height=16, spp=2, bounces=1, tri_block=8)
    scene0 = scene_fn(jnp.float32(1.0))
    table = build_edge_table(scene0)
    cot = jnp.ones((16, 16, 3), jnp.float32)
    g = primary_edge_gradient(
        scene_fn, jnp.float32(1.0), cam, settings, cot, table,
        jax.random.PRNGKey(1), n_samples=256, trace_spp=1,
    )
    assert float(g) == 0.0


@pytest.mark.slow
def test_shadow_edge_gradient_through_mirror_fd():
    """Shadow silhouettes seen IN A REFLECTION (specular_depth=2): the
    camera sees only a mirror; the shadowed floor lives entirely behind the
    camera. depth=1 (the round-3 estimator) is provably blind (gradient
    exactly 0), as is the detached interior; depth=2 walks the mirror
    segment and matches FD. The frozen-chain re-derivation carries the
    receiver x(θ) through resolve_hits + reflect per segment."""
    from gpupathtracer_tpu.grad.edges import build_edge_table, shadow_edge_gradient

    GREY = {"type": "diffuse", "albedo": (0.6, 0.6, 0.6)}
    MIRROR = {"type": "mirror", "specular_color": (0.9, 0.9, 0.9)}
    LIGHT = {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 10.0}

    def scene_fn(s):
        occ = GeometrySpec(
            vertices=jnp.asarray(QUAD) * s,
            normals=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (2, 3, 3)),
            uvs=jnp.zeros((2, 3, 2)),
            position=jnp.asarray([0.0, 3.0, 3.0]),
            rotation_deg=jnp.asarray([90.0, 0.0, 0.0]),
            scale=jnp.ones(3),
            mat_id=2,
            two_sided=True,
        )
        mirror = plane_spec((0.0, 1.0, -1.0), (0.0, 0.0, 0.0), (6.0, 6.0, 1.0), mat_id=3)
        # Floor spans z in [4, 16]: strictly behind the camera (z = 4).
        floor = plane_spec((0.0, 0.0, 10.0), (90.0, 0.0, 0.0), (12.0, 12.0, 12.0), mat_id=0)
        light = plane_spec((0.0, 6.0, -2.0), (90.0, 0.0, 0.0), (3.5, 3.5, 3.5), mat_id=1)
        return build_scene(
            [floor, light, occ, mirror], [GREY, LIGHT, BLACK, MIRROR], pad_to_multiple=8
        )

    cam = Camera.create(
        position=(0.0, 2.0, 4.0), pitch=-10.0, fov_deg=42.0, width=48, height=48
    )
    settings = RenderSettings(
        width=48, height=48, spp=16, bounces=3, tri_block=8,
        estimator="nee", intersector="brute", jitter=True,
    )

    def image_loss(img):
        return jnp.mean(img)

    def loss(s):
        return float(image_loss(render_frame(scene_fn(s), cam, settings)))

    scene0 = scene_fn(jnp.float32(1.0))
    table = build_edge_table(scene0)
    cot = jax.grad(image_loss)(render_frame(scene0, cam, settings))

    g_d1 = float(
        shadow_edge_gradient(
            scene_fn, jnp.float32(1.0), cam, settings, cot, table,
            jax.random.PRNGKey(17), n_samples=2048, specular_depth=1,
        )
    )
    assert g_d1 == 0.0  # first hit is the mirror — depth 1 sees no diffuse x

    g_det = float(
        jax.grad(lambda s: image_loss(render_frame(scene_fn(s), cam, settings)))(
            jnp.float32(1.0)
        )
    )
    assert g_det == 0.0  # detached sampling is fully blind here

    g2 = np.mean(
        [
            float(
                shadow_edge_gradient(
                    scene_fn, jnp.float32(1.0), cam, settings, cot, table,
                    jax.random.PRNGKey(k), n_samples=8192, specular_depth=2,
                )
            )
            for k in (17, 18)
        ]
    )
    h = 0.1
    fd = (loss(1.0 + h) - loss(1.0 - h)) / (2 * h)
    assert fd < 0  # growing the blocker darkens the reflected floor
    np.testing.assert_allclose(g2, fd, rtol=0.35)


def test_shadow_edge_gradient_second_diffuse_fd():
    """Diffuse→diffuse (bounce-2) shadow boundary (VERDICT r4 missing 3):
    the light sits face-up AT floor level, so every camera-visible floor
    point sees it edge-on (cosθ_x ≈ 0) — the bounce-1 NEE term and its
    boundary are ~0 and s-independent, the detached interior is exactly 0,
    and ALL the FD signal is the occluder's shadow sweeping the CEILING,
    reached only at the second diffuse vertex. diffuse_depth=1 (the round-4
    estimator) is provably blind; diffuse_depth=2 walks the detached
    cosine scatter and matches FD."""
    import dataclasses

    from gpupathtracer_tpu.grad.edges import shadow_edge_gradient

    GREY = {"type": "diffuse", "albedo": (0.7, 0.7, 0.7)}
    LIGHT = {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 12.0}

    def scene_fn(s):
        occ = GeometrySpec(
            vertices=jnp.asarray(QUAD) * s,
            normals=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (2, 3, 3)),
            uvs=jnp.zeros((2, 3, 2)),
            position=jnp.asarray([4.5, 0.9, 0.0]),
            rotation_deg=jnp.asarray([90.0, 0.0, 0.0]),
            scale=jnp.ones(3),
            mat_id=2,
            two_sided=True,
        )
        floor = plane_spec((1.0, 0.0, 0.0), (90.0, 0.0, 0.0), (6.0, 6.0, 6.0), mat_id=0)
        ceil = plane_spec((4.0, 3.0, 0.0), (90.0, 0.0, 0.0), (6.0, 6.0, 6.0), mat_id=0)
        light = plane_spec((4.5, 0.02, 0.0), (90.0, 0.0, 0.0), (1.4, 1.4, 1.4), mat_id=1)
        return build_scene([floor, ceil, light, occ], [GREY, LIGHT, BLACK], pad_to_multiple=8)

    cam = Camera.create(
        position=(1.0, 2.2, 2.5), yaw=-90.0, pitch=-50.0, fov_deg=32.0, width=40, height=40
    )
    settings = RenderSettings(
        width=40, height=40, spp=32, bounces=2, tri_block=8,
        estimator="nee", intersector="brute", jitter=True,
    )

    def image_loss(img):
        return jnp.mean(img)

    def loss(s):
        return float(image_loss(render_frame(scene_fn(s), cam, settings)))

    g_det = float(
        jax.grad(lambda s: image_loss(render_frame(scene_fn(s), cam, settings)))(jnp.float32(1.0))
    )
    assert g_det == 0.0  # black occluder, fixed visibility: interior is blind

    scene0 = scene_fn(jnp.float32(1.0))
    table = build_edge_table(scene0)
    # Restrict to occluder edges: static edges contribute exactly zero
    # gradient (their endpoints don't move with s) but dilute pick
    # probability — filtering is pure variance reduction, no bias.
    occ_mask = np.asarray(scene0.geom_id)[table.tri1] == 3
    table = dataclasses.replace(
        table, tri1=table.tri1[occ_mask], corner=table.corner[occ_mask],
        tri2=table.tri2[occ_mask], two_sided=table.two_sided[occ_mask],
    )
    cot = jax.grad(image_loss)(render_frame(scene0, cam, settings))

    g_d1 = float(
        shadow_edge_gradient(
            scene_fn, jnp.float32(1.0), cam, settings, cot, table,
            jax.random.PRNGKey(5), n_samples=2048, diffuse_depth=1,
        )
    )
    assert g_d1 == 0.0  # the first diffuse vertex never sees this shadow

    g2 = np.mean(
        [
            float(
                shadow_edge_gradient(
                    scene_fn, jnp.float32(1.0), cam, settings, cot, table,
                    jax.random.PRNGKey(k), n_samples=4096, diffuse_depth=2,
                )
            )
            for k in (5, 6)
        ]
    )
    h = 0.15
    fd = (loss(1.0 + h) - loss(1.0 - h)) / (2 * h)
    assert fd < 0  # growing the blocker darkens the bounce-2-lit ceiling
    np.testing.assert_allclose(g2, fd, rtol=0.3)


def test_camera_boundary_gradient_fd():
    """dL/d(camera) across silhouettes (VERDICT r4 missing 4): a black quad
    on a uniform emitter — every pixel is locally flat, so the detached
    interior camera gradient is exactly zero and FD is pure silhouette
    sweep; camera_fn routes the boundary term through the differentiable
    projection (position AND yaw)."""
    scene0 = _quad_scene_fn(jnp.float32(0.72))
    target = jax.lax.stop_gradient(
        render_frame(
            scene0,
            QUAD_CAM.replace(
                position=QUAD_CAM.position + jnp.asarray([0.25, 0.0, 0.0]),
                yaw=QUAD_CAM.yaw + 2.0,
            ),
            QUAD_SETTINGS,
        )
    )

    def image_loss(img):
        return jnp.mean((img - target) ** 2)

    def camera_fn(p):
        return QUAD_CAM.replace(
            position=QUAD_CAM.position + jnp.asarray([1.0, 0.0, 0.0]) * p["dx"],
            yaw=QUAD_CAM.yaw + p["yaw"],
        )

    def scene_fn(p):
        return _quad_scene_fn(jnp.float32(0.72))

    def loss_at(dx, yaw):
        return float(
            image_loss(
                render_frame(
                    scene_fn(None),
                    camera_fn({"dx": jnp.float32(dx), "yaw": jnp.float32(yaw)}),
                    QUAD_SETTINGS,
                )
            )
        )

    p0 = {"dx": jnp.float32(0.0), "yaw": jnp.float32(0.0)}
    # Detached interior is blind to the camera here (flat black/flat white).
    g_det = jax.grad(
        lambda p: image_loss(render_frame(scene_fn(p), camera_fn(p), QUAD_SETTINGS))
    )(p0)
    assert float(g_det["dx"]) == 0.0 and float(g_det["yaw"]) == 0.0

    table = build_edge_table(scene0)
    _, g = value_and_grad_with_edges(
        image_loss, scene_fn, p0, QUAD_CAM, QUAD_SETTINGS, table,
        jax.random.PRNGKey(11), n_samples=4096, trace_spp=2, camera_fn=camera_fn,
    )

    h = 0.04
    fd_dx = (loss_at(h, 0.0) - loss_at(-h, 0.0)) / (2 * h)
    h_yaw = 0.5
    fd_yaw = (loss_at(0.0, h_yaw) - loss_at(0.0, -h_yaw)) / (2 * h_yaw)
    assert abs(fd_dx) > 1e-5 and abs(fd_yaw) > 1e-5
    np.testing.assert_allclose(float(g["dx"]), fd_dx, rtol=0.2)
    np.testing.assert_allclose(float(g["yaw"]), fd_yaw, rtol=0.2)


def test_shadow_edge_gradient_through_glass_fd():
    """Shadow silhouettes seen THROUGH A GLASS PANE: the camera views the
    shadowed floor through a tilted refractive pane, so depth-1 walks (and
    the detached interior) are provably blind; the glass-aware specular
    prefix (frozen Fresnel branch + refract in the chain re-derivation)
    must match FD. Completes specular coverage of the walk: MIRROR chains
    (test above) + GLASS reflect/transmit branches."""
    from gpupathtracer_tpu.grad.edges import shadow_edge_gradient

    GREY = {"type": "diffuse", "albedo": (0.6, 0.6, 0.6)}
    LIGHT = {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 6.0}
    GLASS = {
        "type": "glass", "refractive_index": 1.5,
        "transmittance_color": (0.95, 0.95, 0.95),
    }

    def scene_fn(s):
        occ = GeometrySpec(
            vertices=jnp.asarray(QUAD) * s,
            normals=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (2, 3, 3)),
            uvs=jnp.zeros((2, 3, 2)),
            position=jnp.asarray([0.0, 1.5, 0.0]),
            rotation_deg=jnp.asarray([90.0, 0.0, 0.0]),
            scale=jnp.ones(3),
            mat_id=2,
            two_sided=True,
        )
        floor = plane_spec((0.0, 0.0, 0.0), (90.0, 0.0, 0.0), (6.0, 6.0, 6.0), mat_id=0)
        light = plane_spec((0.0, 3.0, 0.0), (90.0, 0.0, 0.0), (1.5, 1.5, 1.5), mat_id=1)
        pane = plane_spec((0.0, 0.8, 2.2), (15.0, 0.0, 0.0), (4.0, 4.0, 1.0), mat_id=3)
        return build_scene(
            [floor, light, occ, pane], [GREY, LIGHT, BLACK, GLASS], pad_to_multiple=8
        )

    cam = Camera.create(
        position=(0.0, 1.0, 4.5), pitch=-25.0, fov_deg=35.0, width=48, height=48
    )
    settings = RenderSettings(
        width=48, height=48, spp=24, bounces=3, tri_block=8,
        estimator="nee", intersector="brute", jitter=True,
    )

    def image_loss(img):
        return jnp.mean(img)

    def loss(s):
        return float(image_loss(render_frame(scene_fn(s), cam, settings)))

    g_det = float(
        jax.grad(lambda s: image_loss(render_frame(scene_fn(s), cam, settings)))(jnp.float32(1.0))
    )
    assert g_det == 0.0

    scene0 = scene_fn(jnp.float32(1.0))
    table = build_edge_table(scene0)
    cot = jax.grad(image_loss)(render_frame(scene0, cam, settings))

    g1 = float(
        shadow_edge_gradient(
            scene_fn, jnp.float32(1.0), cam, settings, cot, table,
            jax.random.PRNGKey(5), n_samples=2048, specular_depth=1,
        )
    )
    assert g1 == 0.0  # every receiver in view lies behind the pane

    g2 = np.mean(
        [
            float(
                shadow_edge_gradient(
                    scene_fn, jnp.float32(1.0), cam, settings, cot, table,
                    jax.random.PRNGKey(k), n_samples=4096, specular_depth=2,
                )
            )
            for k in (5, 6)
        ]
    )
    h = 0.12
    fd = (loss(1.0 + h) - loss(1.0 - h)) / (2 * h)
    assert fd < 0
    np.testing.assert_allclose(g2, fd, rtol=0.3)


def test_value_and_grad_with_edges_composed_options_smoke():
    """The full composition — interior + primary + shadow boundary with
    diffuse_depth=2 AND a camera_fn — executes and returns finite grads
    for a joint (scene, camera) parameter pytree."""
    def scene_fn(p):
        return _quad_scene_fn(p["s"])

    def camera_fn(p):
        return QUAD_CAM.replace(position=QUAD_CAM.position + jnp.asarray([1.0, 0, 0]) * p["dx"])

    table = build_edge_table(scene_fn({"s": jnp.float32(1.0), "dx": jnp.float32(0.0)}))
    p0 = {"s": jnp.float32(1.0), "dx": jnp.float32(0.0)}
    loss, g = value_and_grad_with_edges(
        lambda img: jnp.mean(img), scene_fn, p0, QUAD_CAM, QUAD_SETTINGS, table,
        jax.random.PRNGKey(2), n_samples=256, trace_spp=1,
        shadow_edges=True, shadow_samples=128, shadow_diffuse_depth=2,
        camera_fn=camera_fn,
    )
    assert np.isfinite(float(loss))
    assert np.isfinite(float(g["s"])) and np.isfinite(float(g["dx"]))
    assert float(g["s"]) < 0  # growing the black quad dims the image
