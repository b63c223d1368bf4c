"""Real multi-PROCESS distributed validation (VERDICT round-3 item 2).

Spawns 2 OS processes that each call ``jax.distributed.initialize`` against
a local coordinator (CPU backend, 2 virtual devices each → a 4-device
global mesh), render one globally sharded frame through
``render_frame_distributed``, assemble it with ``gather_image``
(``multihost_utils.process_allgather``), and take one distributed gradient.
The parent renders the same frame single-process and asserts bit-identity —
the SURVEY §4.4 "1-process == N-process assert-equal" promise exercised at
true process granularity (rounds 1–3 only ever covered virtual devices
inside ONE process; ``jax.distributed`` itself had never run).

The reference has no distributed path at all — its only nod to multi-GPU is
a discarded device-id comparison (utilities.h:485-487).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
from meshes import cube_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_render_matches_single_process(tmp_path):
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    n = 2
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_NUM_PROCESSES")
    }
    # Isolate the workers' compile cache from races against each other.
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, str(n), str(i), str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=os.path.dirname(HERE),
        )
        for i in range(n)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-4000:]}"

    # Every process must hold the SAME fully assembled frame and gradient.
    imgs = [np.load(tmp_path / f"img_p{i}.npy") for i in range(n)]
    grads = [np.load(tmp_path / f"grad_p{i}.npy") for i in range(n)]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    np.testing.assert_array_equal(grads[0], grads[1])

    # ... and it must be bit-identical to the single-process render: the
    # worker's exact scene/settings, rendered on this process's devices.
    import jax
    import jax.numpy as jnp

    from gpupathtracer_tpu.models.camera import Camera
    from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
    from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame

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
    ref = np.asarray(render_frame(scene, cam, settings))
    np.testing.assert_array_equal(imgs[0], ref)

    def loss(albedo):
        s = scene.replace(materials=scene.materials.replace(albedo=albedo))
        return jnp.mean(render_frame(s, cam, settings))

    g_ref = np.asarray(jax.grad(loss)(scene.materials.albedo))
    np.testing.assert_allclose(grads[0], g_ref, rtol=1e-5, atol=1e-7)
