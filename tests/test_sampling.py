"""Sampling-warp statistics and shading-frame math (SURVEY.md §4.1)."""

import jax
import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.ops import sampling
from meshes import triangle_mesh


def test_cosine_hemisphere_warp_formula():
    """Spot-check the exact reference warp (utilities.h:46-55)."""
    u1, u2 = 0.25, 0.5
    v = np.asarray(sampling.cosine_sample_hemisphere(jnp.asarray(u1), jnp.asarray(u2)))
    r = np.sqrt(u1)
    theta = 2 * np.pi * u2
    np.testing.assert_allclose(v, [r * np.cos(theta), r * np.sin(theta), np.sqrt(1 - u1)], atol=1e-6)


def test_cosine_hemisphere_statistics():
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (20000, 2))
    v = np.asarray(sampling.cosine_sample_hemisphere(u[:, 0], u[:, 1]))
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-5)
    assert (v[:, 2] >= 0).all()
    # E[cos θ] = 2/3 under pdf = cosθ/π.
    np.testing.assert_allclose(v[:, 2].mean(), 2.0 / 3.0, atol=0.01)
    # E[x] = E[y] = 0 by symmetry.
    np.testing.assert_allclose(v[:, 0].mean(), 0.0, atol=0.02)


def test_pdf():
    np.testing.assert_allclose(
        float(sampling.cosine_hemisphere_pdf(jnp.asarray(0.5))), 0.5 / np.pi, rtol=1e-6
    )


def test_onb_orthonormal():
    rng = np.random.default_rng(0)
    n = rng.normal(size=(100, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t, b = sampling.make_onb(jnp.asarray(n, jnp.float32))
    t, b = np.asarray(t), np.asarray(b)
    np.testing.assert_allclose(np.sum(t * n, -1), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.sum(b * n, -1), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.sum(t * b, -1), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(b, axis=1), 1.0, atol=1e-5)


def test_local_to_world_preserves_z():
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    local = jnp.asarray([[0.0, 0.0, 1.0]])
    w = np.asarray(sampling.local_to_world(local, n))
    np.testing.assert_allclose(w, [[0, 1, 0]], atol=1e-6)


def test_reflect():
    d = jnp.asarray([[1.0, -1.0, 0.0]]) / np.sqrt(2)
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    r = np.asarray(sampling.reflect(d, n))
    np.testing.assert_allclose(r, np.asarray([[1.0, 1.0, 0.0]]) / np.sqrt(2), atol=1e-6)


def test_refract_straight_through():
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    n = jnp.asarray([[0.0, 0.0, 1.0]])
    refr, tir = sampling.refract(d, n, jnp.asarray([[1.0 / 1.5]]))
    np.testing.assert_allclose(np.asarray(refr), [[0, 0, -1]], atol=1e-6)
    assert not bool(tir[0])


def test_total_internal_reflection():
    # Grazing exit from dense medium: eta = 1.5, incidence > critical angle.
    ang = np.deg2rad(60.0)
    d = jnp.asarray([[np.sin(ang), 0.0, -np.cos(ang)]], jnp.float32)
    n = jnp.asarray([[0.0, 0.0, 1.0]])
    _, tir = sampling.refract(d, n, jnp.asarray([[1.5]]))
    assert bool(tir[0])


def test_fresnel_limits():
    # Normal incidence: r0 = ((1-1.5)/(2.5))^2 = 0.04.
    f0 = float(sampling.fresnel_schlick(jnp.asarray(1.0), 1.0, 1.5))
    np.testing.assert_allclose(f0, 0.04, rtol=1e-5)
    # Grazing: → 1.
    fg = float(sampling.fresnel_schlick(jnp.asarray(0.0), 1.0, 1.5))
    np.testing.assert_allclose(fg, 1.0, rtol=1e-5)


def test_keys_deterministic_and_distinct():
    base = jax.random.PRNGKey(1234)
    pix = jnp.arange(8, dtype=jnp.uint32)
    k1 = sampling.pixel_sample_key(base, pix, 0)
    k2 = sampling.pixel_sample_key(base, pix, 0)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(k1)), np.asarray(jax.random.key_data(k2))
    )
    k3 = sampling.pixel_sample_key(base, pix, 1)
    assert not np.array_equal(
        np.asarray(jax.random.key_data(k1)), np.asarray(jax.random.key_data(k3))
    )
    # Distinct pixels get distinct keys.
    kd = np.asarray(jax.random.key_data(k1))
    assert len({tuple(row) for row in kd.reshape(8, -1)}) == 8


# --- PCG4D sampler (the default RNG engine) ----------------------------------


def _pcg_draws(n=1 << 16, seed=7, sample=0, stream=0):
    S = sampling.PcgSampler
    keys = S.path_keys(jax.random.PRNGKey(seed), jnp.arange(n, dtype=jnp.uint32), sample)
    if stream:
        keys = S.fold(keys, stream)
    return np.asarray(S.uniform(keys, 4))


def test_pcg_uniform_statistics():
    """Mean/variance/range of PCG4D draws match U[0,1) closely (64k lanes)."""
    u = _pcg_draws()
    assert u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_allclose(u.mean(axis=0), 0.5, atol=0.005)
    np.testing.assert_allclose(u.var(axis=0), 1.0 / 12.0, atol=0.002)
    # Lane-to-lane correlation of adjacent pixels ~ 0 (counter-based hash).
    for c in range(4):
        r = np.corrcoef(u[:-1, c], u[1:, c])[0, 1]
        assert abs(r) < 0.02, f"adjacent-lane correlation {r} in word {c}"


def test_pcg_streams_decorrelated():
    """seed/sample/stream folds each give fresh, uncorrelated sequences."""
    base = _pcg_draws()
    for other in (
        _pcg_draws(seed=8),
        _pcg_draws(sample=1),
        _pcg_draws(stream=0x11EE),
    ):
        assert not np.array_equal(base, other)
        r = np.corrcoef(base[:, 0], other[:, 0])[0, 1]
        assert abs(r) < 0.02


def test_pcg_deterministic_and_fold_injective():
    a = _pcg_draws()
    b = _pcg_draws()
    np.testing.assert_array_equal(a, b)
    # The fold chains the integrator uses ([b], [b, 0x11EE], [b, 7919],
    # [0xA11A]) must land on distinct streams for every bounce index.
    S = sampling.PcgSampler
    k = S.path_keys(jax.random.PRNGKey(0), jnp.arange(4, dtype=jnp.uint32), 0)
    streams = set()
    for bounce in range(8):
        kb = S.fold(k, bounce)
        for chain in (kb, S.fold(kb, 0x11EE), S.fold(kb, 7919), S.fold(k, 0xA11A)):
            streams.add(int(np.asarray(chain[0, 3])))
    assert len(streams) == 8 * 3 + 1  # 0xA11A chain is bounce-independent


def test_pcg_vs_threefry_estimator_agreement():
    """The two RNG engines are interchangeable estimators: same scene, same
    spp, means agree within Monte Carlo noise (engine swap changes samples,
    never the integrand)."""
    from gpupathtracer_tpu.models.camera import Camera
    from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
    from gpupathtracer_tpu.render.renderer import RenderSettings, render_frame

    scene = build_scene(
        [
            mesh_spec(triangle_mesh(), mat_id=0),
            plane_spec((0.5, 0.5, -1.5), (0, 0, 0), (8, 8, 8), mat_id=1),
        ],
        [
            {"type": "diffuse", "albedo": (0.8, 0.3, 0.2)},
            {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
        ],
        pad_to_multiple=8,
    )
    cam = Camera.create(position=(0.5, 0.5, 3.0), width=24, height=24)
    mean = {}
    for impl in ("pcg", "threefry"):
        s = RenderSettings(
            width=24, height=24, spp=96, bounces=2, tri_block=8,
            intersector="brute", rng=impl,
        )
        mean[impl] = float(np.asarray(render_frame(scene, cam, s)).mean())
    assert abs(mean["pcg"] - mean["threefry"]) / max(mean["threefry"], 1e-9) < 0.05, mean
