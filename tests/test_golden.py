"""Golden-image regression suite (SURVEY.md §4.2): small-res renders of the
BASELINE workloads against committed golden arrays — one per estimator
family and intersection backend class. Guards the whole stack — camera math,
scene compile, intersection, estimators, RNG — against silent behavior
changes (the reference's de facto methodology: its committed render.ppm —
done right). Regenerate deliberately with:

    python tests/test_golden.py regenerate [name ...]
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from meshes import triangle_mesh  # noqa: E402

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _triangle_scene():
    from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec

    return build_scene(
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


def _render_config1(intersector="brute", estimator="naive"):
    from gpupathtracer_tpu.models.camera import Camera
    from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame

    cam = Camera.create(position=(0.5, 0.5, 3.0), width=64, height=64)
    tb = 128 if intersector == "pallas" else 8
    settings = RenderSettings(
        width=64, height=64, spp=4, bounces=2, tri_block=tb,
        intersector=intersector, estimator=estimator,
    )
    scene = _triangle_scene()
    if intersector == "pallas":
        from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec

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
    return np.asarray(render_frame(scene, cam, settings))


def _render_scene_config(path, width, height, spp, **overrides):
    from gpupathtracer_tpu.render.renderer import render_frame
    from gpupathtracer_tpu.utils.config import load_scene_file

    scenes = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")
    scene, camera, settings = load_scene_file(os.path.join(scenes, path))
    settings = dataclasses.replace(
        settings, width=width, height=height, spp=spp, **overrides
    )
    camera = camera.replace(width=width, height=height)
    return np.asarray(render_frame(scene, camera, settings))


def _render_config5_target():
    from gpupathtracer_tpu.grad.inverse import _demo_setup
    from gpupathtracer_tpu.render.renderer import render_frame

    import jax.numpy as jnp

    settings, camera, make_scene, mesh = _demo_setup(
        width=48, height=48, spp=4, bounces=2, subdivisions=1
    )
    base = jnp.asarray(mesh.vertices) * 1.2
    scene = make_scene(
        jnp.asarray([0.2, 0.55, 0.85]), base * jnp.asarray([0.0, -0.15, 0.0])
    )
    return np.asarray(render_frame(scene, camera, settings))


# name -> (render_fn, atol). NEE/MIS goldens cover the estimator family;
# the pallas case runs the kernel through the Pallas interpreter on CPU.
CASES = {
    "config1_64": (lambda: _render_config1(), 2e-5),
    "config1_pallas_64": (lambda: _render_config1(intersector="pallas"), 2e-5),
    "config1_nee_64": (lambda: _render_config1(estimator="nee"), 2e-5),
    "config2_cornell_48": (
        lambda: _render_scene_config(
            "config2_cornell.toml", 48, 48, 8, tri_block=8, intersector="brute"
        ),
        3e-5,
    ),
    "config4_occlusion_48": (
        lambda: _render_scene_config(
            "config4_occlusion.toml", 48, 48, 4, tri_block=8, intersector="brute"
        ),
        3e-5,
    ),
    "config5_target_48": (_render_config5_target, 3e-5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden(name):
    render_fn, atol = CASES[name]
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    assert os.path.exists(path), f"golden missing: regenerate {name}"
    img = render_fn()
    with np.load(path) as z:
        golden = z["image"]
    np.testing.assert_allclose(img, golden, atol=atol)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "regenerate":
        import jax

        jax.config.update("jax_platforms", "cpu")
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        names = sys.argv[2:] or sorted(CASES)
        for name in names:
            np.savez_compressed(
                os.path.join(GOLDEN_DIR, f"{name}.npz"), image=CASES[name][0]()
            )
            print(f"wrote {name}.npz")
