"""Fault injection (SURVEY.md §5 failure detection / elastic recovery):
a render job is SIGKILLed mid-flight between checkpoints; rerunning with the
same arguments resumes from the last checkpoint and produces a final image
bit-identical to a never-interrupted run."""

import os
import signal
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, signal, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

sys.path.insert(0, {repo!r})
sys.path.insert(0, os.path.join({repo!r}, "tests"))
from meshes import triangle_mesh
from gpupathtracer_tpu.models.camera import Camera
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.render.progressive import render_progressive
from gpupathtracer_tpu.render.renderer import RenderSettings
from gpupathtracer_tpu.utils import checkpoint as ckpt

# Fault injection: die hard (SIGKILL — no cleanup, like a preemption)
# right after the second checkpoint write.
if os.environ.get("INJECT_FAULT") == "1":
    orig_save = ckpt.save_film
    state = {{"n": 0}}
    def killing_save(path, film, done, settings):
        orig_save(path, film, done, settings)
        state["n"] += 1
        if state["n"] == 2:
            os.kill(os.getpid(), signal.SIGKILL)
    ckpt.save_film = killing_save

scene = build_scene(
    [
        mesh_spec(triangle_mesh(), mat_id=0),
        plane_spec((0.5, 0.5, -1.5), (0, 0, 0), (4, 4, 4), mat_id=1),
    ],
    [
        {{"type": "diffuse", "albedo": (1.0, 0.0, 0.0)}},
        {{"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0}},
    ],
    pad_to_multiple=8,
)
cam = Camera.create(position=(0.5, 0.5, 3.0), width=16, height=16)
settings = RenderSettings(
    width=16, height=16, spp=6, bounces=2, tri_block=8, intersector="brute"
)
img = render_progressive(
    scene, cam, settings, chunk_spp=1,
    checkpoint_path=sys.argv[1], checkpoint_every=1,
)
np.save(sys.argv[2], img)
"""


def test_sigkill_resume_bit_identical(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=REPO))
    ckpt_path = str(tmp_path / "film.npz")
    out_fault = str(tmp_path / "resumed.npy")
    out_clean = str(tmp_path / "clean.npy")
    env = dict(os.environ)

    # Run 1: killed by SIGKILL after the 2nd of 6 checkpoints.
    env["INJECT_FAULT"] = "1"
    p = subprocess.run(
        [sys.executable, str(worker), ckpt_path, out_fault],
        env=env, capture_output=True, timeout=300,
    )
    assert p.returncode == -signal.SIGKILL, p.stderr.decode()[-2000:]
    assert os.path.exists(ckpt_path), "no checkpoint before the kill"
    assert not os.path.exists(out_fault), "job must not have finished"

    # Run 2: same arguments — resumes at the first missing sample, completes.
    env["INJECT_FAULT"] = "0"
    p = subprocess.run(
        [sys.executable, str(worker), ckpt_path, out_fault],
        env=env, capture_output=True, timeout=300,
    )
    assert p.returncode == 0, p.stderr.decode()[-2000:]

    # Uninterrupted run with no prior checkpoint.
    p = subprocess.run(
        [sys.executable, str(worker), str(tmp_path / "other.npz"), out_clean],
        env=env, capture_output=True, timeout=300,
    )
    assert p.returncode == 0, p.stderr.decode()[-2000:]

    np.testing.assert_array_equal(np.load(out_fault), np.load(out_clean))
