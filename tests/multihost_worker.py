"""Worker process for tests/test_multihost.py — real multi-PROCESS JAX.

Each OS process runs `jax.distributed.initialize` against a shared local
coordinator (CPU backend, 2 virtual devices per process), renders its view
of a globally sharded frame through the real distributed entry points
(parallel/render.py::render_frame_distributed over the global mesh), and
assembles the full framebuffer with parallel/multihost.py::gather_image
(multihost_utils.process_allgather). It also takes one distributed gradient
(jax.grad through the shard_map, psum inserted by XLA) to exercise the
training path. Outputs land in .npy files the parent test compares against
the single-process render — the SURVEY §4.4 "1-process == N-process
assert-equal" contract at true process granularity.

Usage: python multihost_worker.py <coordinator> <num_procs> <proc_id> <outdir>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from meshes import cube_mesh  # noqa: E402


def main():
    coordinator, num_procs, proc_id, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    # 2 virtual CPU devices per process -> a (num_procs*2)-device global mesh.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
    )

    import jax

    # CPU processes, as in tests/conftest.py.
    jax.config.update("jax_platforms", "cpu")
    # Multi-process CPU needs a cross-process collectives backend; without
    # it the CPU client comes up single-process (process_count() == 1).
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from gpupathtracer_tpu.ops import pallas_intersect
    from gpupathtracer_tpu.parallel.multihost import gather_image, init_distributed

    # The GPU-only kernel runs through the Pallas interpreter here.
    pallas_intersect.INTERPRET = True

    init_distributed(
        coordinator_address=coordinator, num_processes=num_procs, process_id=proc_id
    )
    assert jax.process_count() == num_procs, jax.process_count()
    assert len(jax.devices()) == 2 * num_procs, jax.devices()

    import jax.numpy as jnp
    import numpy as np

    from gpupathtracer_tpu.models.camera import Camera
    from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
    from gpupathtracer_tpu.parallel.mesh import make_mesh
    from gpupathtracer_tpu.parallel.render import render_frame_distributed
    from gpupathtracer_tpu.render.renderer import RenderSettings

    scene = build_scene(
        [
            mesh_spec(cube_mesh(), mat_id=0),
            plane_spec((0.0, 2.0, 0.0), (90.0, 0.0, 0.0), (4.0, 4.0, 4.0), mat_id=1),
        ],
        [
            {"type": "diffuse", "albedo": (0.8, 0.3, 0.2)},
            {"type": "emitter", "emissive_color": (1.0, 0.95, 0.9), "intensity": 5.0},
        ],
        pad_to_multiple=8,
    )
    cam = Camera.create(position=(0.0, 0.0, 6.0), width=32, height=32)
    settings = RenderSettings(
        width=32, height=32, spp=2, bounces=2, tri_block=8, estimator="nee",
        # The intersector "auto" picks on a GPU (the Pallas kernel, through
        # the interpreter here): the real jax.distributed 2-process run
        # exercises the kernel the cards run.
        intersector="pallas",
    )

    mesh = make_mesh(n_scene=2)  # (data=2, scene=2) over 4 global devices
    img = render_frame_distributed(scene, cam, settings, mesh)
    full = gather_image(img)

    def loss(albedo):
        s = scene.replace(materials=scene.materials.replace(albedo=albedo))
        return jnp.mean(render_frame_distributed(s, cam, settings, mesh))

    g = jax.grad(loss)(scene.materials.albedo)
    g_full = gather_image(g)

    np.save(os.path.join(outdir, f"img_p{proc_id}.npy"), full)
    np.save(os.path.join(outdir, f"grad_p{proc_id}.npy"), g_full)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
