"""Inverse rendering (BASELINE.json config 5): recover scene parameters from
a target image via pixel gradients.

Demo task: a Lambertian icosphere lit by an emissive backdrop
(scenes/config5_invert_target.toml). The optimizer recovers
- per-material albedo,
- per-vertex offsets of the sphere's triangle soup,
from the target rendering, using Adam (optax) on an L2 image loss through
``render_frame`` — dL/d(vertex, material) flows through scene compile,
intersection attribute resolution, and the wavefront integrator.

Estimator notes: this demo's default loop uses detached sampling — the
sample directions and the discrete closest-hit selection are
stop_gradient'ed, so gradients are exact for shading-path parameters
(albedo, emission) and first-order correct for geometry within the fixed
visibility topology; for this smooth-coverage recovery task the omitted
boundary term is a small bias. When silhouette motion IS the signal,
compose the edge-sampled boundary estimator via
``grad.edges.value_and_grad_with_edges`` (FD-validated in
tests/test_edges.py; the occluder-scale recovery there is exactly the task
detached sampling cannot solve). FD validation for this loop's parameters
lives in tests/test_grad.py (SURVEY.md §4.3).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gpupathtracer_tpu.models.camera import Camera
from gpupathtracer_tpu.models.materials import material_table
from gpupathtracer_tpu.models.scene import GeometrySpec, build_scene, icosphere, plane_spec
from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame


@dataclasses.dataclass
class InverseResult:
    loss_history: list
    albedo_error: float
    vertex_error: float
    final_loss: float


def _demo_setup(width=96, height=96, spp=8, bounces=2, subdivisions=2):
    settings = RenderSettings(
        width=width, height=height, spp=spp, bounces=bounces, seed=1234,
        tri_block=512, intersector="auto", estimator="nee",
    )
    camera = Camera.create(position=(0.0, 0.0, 6.0), fov_deg=45.0, width=width, height=height)
    sphere_mesh = icosphere(subdivisions)
    backdrop = plane_spec((0.0, 0.0, 8.0), (0.0, 0.0, 0.0), (30.0, 30.0, 30.0), mat_id=1)

    def make_scene(albedo, vertex_offsets):
        sphere = GeometrySpec(
            vertices=jnp.asarray(sphere_mesh.vertices) * 1.2 + vertex_offsets,
            normals=jnp.asarray(sphere_mesh.normals),
            uvs=jnp.asarray(sphere_mesh.uvs),
            position=jnp.zeros(3),
            rotation_deg=jnp.zeros(3),
            scale=jnp.ones(3),
            mat_id=0,
        )
        materials = material_table(
            [
                {"type": "diffuse"},
                {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 3.0},
            ]
        )
        materials = materials.replace(albedo=materials.albedo.at[0].set(albedo))
        return build_scene([sphere, backdrop], materials, pad_to_multiple=512)

    return settings, camera, make_scene, sphere_mesh


def run_silhouette_demo(
    steps: int = 40,
    lr: float = 3e-2,
    width: int = 64,
    height: int = 64,
    spp: int = 16,
    true_scale: float = 0.72,
    init_scale: float = 1.1,
    edge_samples: int = 1024,
    out_dir: str | None = None,
):
    """Recover an occluder's scale from a target image — the task detached
    sampling provably cannot move (the occluder is black: every interior
    gradient is exactly zero; ALL signal is silhouette motion). Uses the
    edge-sampled boundary estimator (grad/edges.py), demonstrating SURVEY
    §7.3's visibility gradients end-to-end. Mirrors
    tests/test_edges.py::test_silhouette_recovery_beats_detached.
    """
    from gpupathtracer_tpu.grad.edges import build_edge_table, value_and_grad_with_edges
    from gpupathtracer_tpu.models.scene import GeometrySpec, plane_spec

    quad = jnp.asarray(
        [
            [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0]],
            [[-0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]],
        ],
        jnp.float32,
    )
    camera = Camera.create(position=(0.0, 0.0, 4.0), fov_deg=45.0, width=width, height=height)
    settings = RenderSettings(
        width=width, height=height, spp=spp, bounces=1, tri_block=8,
        estimator="naive", intersector="auto", jitter=True,
    )

    def scene_fn(s):
        occ = GeometrySpec(
            vertices=quad * s,
            normals=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (2, 3, 3)),
            uvs=jnp.zeros((2, 3, 2)),
            position=jnp.zeros(3),
            rotation_deg=jnp.zeros(3),
            scale=jnp.ones(3),
            mat_id=0,
        )
        backdrop = plane_spec((0.0, 0.0, -2.0), (0.0, 0.0, 0.0), (40.0, 40.0, 40.0), mat_id=1)
        return build_scene(
            [occ, backdrop],
            material_table(
                [
                    {"type": "diffuse", "albedo": (0.0, 0.0, 0.0)},
                    {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
                ]
            ),
            pad_to_multiple=8,
        )

    target = jax.lax.stop_gradient(
        render_frame(scene_fn(jnp.float32(true_scale)), camera, settings)
    )

    def image_loss(img):
        return jnp.mean((img - target) ** 2)

    table = build_edge_table(scene_fn(jnp.float32(init_scale)))
    s = jnp.float32(init_scale)
    opt = optax.adam(lr)
    state = opt.init(s)
    key = jax.random.PRNGKey(3)
    history = []
    detached_g0 = float(
        jax.grad(lambda v: image_loss(render_frame(scene_fn(v), camera, settings)))(s)
    )
    for i in range(steps):
        key, k = jax.random.split(key)
        loss, g = value_and_grad_with_edges(
            image_loss, scene_fn, s, camera, settings, table, k,
            n_samples=edge_samples, trace_spp=2,
        )
        upd, state = opt.update(g, state, s)
        s = optax.apply_updates(s, upd)
        if i % 5 == 0 or i == steps - 1:
            history.append((i, float(loss), round(float(s), 4)))
    result = {
        "task": "silhouette_scale_recovery",
        "true_scale": true_scale,
        "recovered_scale": round(float(s), 4),
        "scale_error": round(abs(float(s) - true_scale), 4),
        "detached_gradient_at_init": detached_g0,  # provably ~0 — edges carry all signal
        "history": history,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        from gpupathtracer_tpu.render.film import to_u8
        from gpupathtracer_tpu.utils.image import write_png

        final = render_frame(scene_fn(s), camera, settings)
        write_png(os.path.join(out_dir, "target.png"), to_u8(np.asarray(target)))
        write_png(os.path.join(out_dir, "recovered.png"), to_u8(np.asarray(final)))
    return result


def run_camera_demo(
    steps: int = 60,
    lr: float = 2e-2,
    width: int = 64,
    height: int = 64,
    spp: int = 16,
    true_dx: float = 0.3,
    true_dz: float = 0.45,
    edge_samples: int = 2048,
    out_dir: str | None = None,
):
    """Recover the CAMERA pose (x and z translation) from a target image —
    a task where the detached interior gradient is exactly zero (black
    occluder on a uniform emitter: every pixel is locally flat wrt the
    camera) and ALL signal is silhouette sweep: dx shifts the silhouette,
    dz scales it. Uses camera_fn in value_and_grad_with_edges (the camera
    boundary term, VERDICT r4 missing 4); yaw/position gradients are
    FD-validated in tests/test_edges.py::test_camera_boundary_gradient_fd.
    """
    from gpupathtracer_tpu.grad.edges import build_edge_table, value_and_grad_with_edges
    from gpupathtracer_tpu.models.scene import plane_spec

    quad = jnp.asarray(
        [
            [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0]],
            [[-0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]],
        ],
        jnp.float32,
    )
    base_cam = Camera.create(position=(0.0, 0.0, 4.0), fov_deg=45.0, width=width, height=height)
    settings = RenderSettings(
        width=width, height=height, spp=spp, bounces=1, tri_block=8,
        estimator="naive", intersector="auto", jitter=True,
    )

    def scene_fn(_p):
        occ = GeometrySpec(
            vertices=quad * 0.72,
            normals=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (2, 3, 3)),
            uvs=jnp.zeros((2, 3, 2)),
            position=jnp.zeros(3),
            rotation_deg=jnp.zeros(3),
            scale=jnp.ones(3),
            mat_id=0,
        )
        backdrop = plane_spec((0.0, 0.0, -2.0), (0.0, 0.0, 0.0), (40.0, 40.0, 40.0), mat_id=1)
        return build_scene(
            [occ, backdrop],
            material_table(
                [
                    {"type": "diffuse", "albedo": (0.0, 0.0, 0.0)},
                    {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
                ]
            ),
            pad_to_multiple=8,
        )

    def camera_fn(p):
        return base_cam.replace(
            position=base_cam.position
            + jnp.asarray([1.0, 0.0, 0.0]) * p["dx"]
            + jnp.asarray([0.0, 0.0, 1.0]) * p["dz"],
        )

    target = jax.lax.stop_gradient(
        render_frame(
            scene_fn(None),
            camera_fn({"dx": jnp.float32(true_dx), "dz": jnp.float32(true_dz)}),
            settings,
        )
    )

    def image_loss(img):
        return jnp.mean((img - target) ** 2)

    params = {"dx": jnp.float32(0.0), "dz": jnp.float32(0.0)}
    detached_g0 = jax.grad(
        lambda p: image_loss(render_frame(scene_fn(p), camera_fn(p), settings))
    )(params)

    table = build_edge_table(scene_fn(None))
    opt = optax.adam(lr)
    state = opt.init(params)
    key = jax.random.PRNGKey(9)
    history = []
    for i in range(steps):
        key, k = jax.random.split(key)
        loss, g = value_and_grad_with_edges(
            image_loss, scene_fn, params, base_cam, settings, table, k,
            n_samples=edge_samples, trace_spp=2, camera_fn=camera_fn,
        )
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        if i % 5 == 0 or i == steps - 1:
            history.append((i, float(loss), round(float(params["dx"]), 4), round(float(params["dz"]), 4)))
    result = {
        "task": "camera_pose_recovery",
        "true": {"dx": true_dx, "dz": true_dz},
        "recovered": {"dx": round(float(params["dx"]), 4), "dz": round(float(params["dz"]), 4)},
        "dx_error": round(abs(float(params["dx"]) - true_dx), 4),
        "dz_error": round(abs(float(params["dz"]) - true_dz), 4),
        # Provably ~0 — the boundary term carries all camera signal here.
        "detached_gradient_at_init": {
            "dx": float(detached_g0["dx"]), "dz": float(detached_g0["dz"])
        },
        "history": history,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        from gpupathtracer_tpu.render.film import to_u8
        from gpupathtracer_tpu.utils.image import write_png

        final = render_frame(scene_fn(None), camera_fn(params), settings)
        write_png(os.path.join(out_dir, "target.png"), to_u8(np.asarray(target)))
        write_png(os.path.join(out_dir, "recovered.png"), to_u8(np.asarray(final)))
    return result


def run_inverse_demo(
    steps: int = 100,
    out_dir: str | None = None,
    lr: float = 2e-2,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    width: int = 96,
    height: int = 96,
    spp: int = 8,
    bounces: int = 2,
    subdivisions: int = 2,
):
    """Optimize albedo + vertex offsets to match the target image.

    With ``checkpoint_path``, (params, optimizer state, step) are saved
    atomically every ``checkpoint_every`` steps (utils/checkpoint.py) and a
    rerun resumes at the first missing step. Per-step RNG seeds are the
    global step index, so an interrupted-and-resumed optimization is
    bit-identical to an uninterrupted one (mirrors the film-checkpoint
    guarantee; tested in tests/test_inverse.py).
    """
    from gpupathtracer_tpu.utils import checkpoint as ckpt

    settings, camera, make_scene, sphere_mesh = _demo_setup(
        width=width, height=height, spp=spp, bounces=bounces, subdivisions=subdivisions
    )
    t_v = sphere_mesh.vertices.shape[0]

    true_albedo = jnp.asarray([0.2, 0.55, 0.85])
    # Target shape: sphere squashed along y by 15% (soup-level offsets).
    base = jnp.asarray(sphere_mesh.vertices) * 1.2
    true_offsets = base * jnp.asarray([0.0, -0.15, 0.0])
    target = render_frame(make_scene(true_albedo, true_offsets), camera, settings)
    target = jax.lax.stop_gradient(target)

    params = {
        "albedo_logit": jnp.zeros((3,)),  # sigmoid → albedo in (0,1)
        "offsets": jnp.zeros((t_v, 3, 3)),
    }
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    start_step = 0
    if checkpoint_path:
        loaded = ckpt.load_train_state(checkpoint_path)
        if loaded is not None:
            params = jax.tree_util.tree_map(jnp.asarray, loaded["params"])
            opt_state = jax.tree_util.tree_map(jnp.asarray, loaded["opt_state"])
            start_step = int(loaded["step"])

    def loss_fn(p, seed):
        albedo = jax.nn.sigmoid(p["albedo_logit"])
        scene = make_scene(albedo, p["offsets"])
        img = render_frame(scene, camera, settings, seed=seed)
        return jnp.mean((img - target) ** 2)

    @jax.jit
    def step(p, s, seed):
        loss, grads = jax.value_and_grad(loss_fn)(p, seed)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    history = []
    for i in range(start_step, steps):
        params, opt_state, loss = step(params, opt_state, jnp.uint32(i))
        history.append((i, float(loss)))
        if checkpoint_path and ((i + 1) % checkpoint_every == 0 or i == steps - 1):
            ckpt.save_train_state(checkpoint_path, params, opt_state, i + 1)
    if not history:  # fully resumed past the end — report the current loss
        history.append((steps - 1, float(loss_fn(params, jnp.uint32(max(steps - 1, 0))))))

    albedo = jax.nn.sigmoid(params["albedo_logit"])
    albedo_err = float(jnp.max(jnp.abs(albedo - true_albedo)))
    vert_err = float(jnp.mean(jnp.abs(params["offsets"] - true_offsets)))
    result = {
        "steps": steps,
        "final_loss": history[-1][1],
        "albedo_recovered": [round(float(x), 4) for x in albedo],
        "albedo_true": [float(x) for x in true_albedo],
        "albedo_max_err": round(albedo_err, 4),
        "vertex_offset_mae": round(vert_err, 5),
        "loss_history": history,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        from gpupathtracer_tpu.render.film import to_u8
        from gpupathtracer_tpu.utils.image import write_png

        final = render_frame(make_scene(albedo, params["offsets"]), camera, settings)
        write_png(os.path.join(out_dir, "target.png"), to_u8(np.asarray(target)))
        write_png(os.path.join(out_dir, "recovered.png"), to_u8(np.asarray(final)))
    return result
