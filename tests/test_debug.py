"""Sanitizer-mode coverage (SURVEY.md §5 race detection / sanitizers):
checkify-wrapped rendering reports no NaN/OOB on a healthy scene, catches an
injected NaN, and debug_mode round-trips cleanly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.models.camera import Camera
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame
from gpupathtracer_tpu.utils.debug import checkify_render, debug_mode
from meshes import triangle_mesh


def _small_scene():
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
    cam = Camera.create(position=(0.5, 0.5, 3.0), width=16, height=16)
    settings = RenderSettings(width=16, height=16, spp=2, bounces=2, tri_block=8)
    return scene, cam, settings


def test_checkify_render_clean_scene():
    scene, cam, settings = _small_scene()

    def render(s):
        return render_frame(s, cam, settings)

    err, img = checkify_render(render)(scene)
    err.throw()  # no NaN/inf/OOB anywhere in the whole frame computation
    np.testing.assert_array_equal(np.asarray(img), np.asarray(render(scene)))


def test_checkify_catches_injected_nan():
    scene, cam, settings = _small_scene()
    bad = scene.replace(v0=scene.v0.at[0, 0].set(jnp.nan))

    def render(s):
        return render_frame(s, cam, settings)

    err, _ = checkify_render(render)(bad)
    with pytest.raises(Exception):
        err.throw()


def test_debug_mode_roundtrip():
    scene, cam, settings = _small_scene()
    with debug_mode():
        img = np.asarray(render_frame(scene, cam, settings))
    assert np.isfinite(img).all()
    assert not jax.config.jax_debug_nans  # restored on exit


@pytest.mark.parametrize("env_dir", [None, "from_env"])
def test_compile_cache_dir_choice(env_dir, tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is used and the
    code sets none itself; unset, the cache is the fixed in-checkout dir."""
    import os

    from gpupathtracer_tpu.utils import debug

    old = jax.config.jax_compilation_cache_dir
    set_dirs = []
    real_update = jax.config.update

    def spy(name, value):
        if name == "jax_compilation_cache_dir":
            set_dirs.append(value)
        return real_update(name, value)

    monkeypatch.setattr(jax.config, "update", spy)
    try:
        if env_dir:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env_dir))
            assert debug.enable_compile_cache() == str(tmp_path / env_dir)
            assert set_dirs == []
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = debug.enable_compile_cache()
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert got == os.path.join(repo, ".jax_cache") == debug.DEFAULT_COMPILE_CACHE_DIR
            assert set_dirs == [got]
    finally:
        real_update("jax_compilation_cache_dir", old)
