"""Sampling warps and shading-frame math.

Counter-based deterministic sampling replaces the reference's curand usage
(fixed seed 1234, re-seeded inside every bsdf call with a 1-D thread id —
``utilities.h:109-128``, a documented reference bug, SURVEY.md §2.3.5). Keys
are derived with ``jax.random.fold_in`` over (pixel, sample, bounce) so the
sample sequence is reproducible, layout-invariant, and shard-invariant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cosine_sample_hemisphere(u1, u2):
    """The reference's square→cosine-hemisphere warp (utilities.h:46-55).

    r = sqrt(u1), theta = 2*pi*u2 → (r cos θ, r sin θ, sqrt(1-u1)); local
    frame with +z = normal; pdf = cosθ/π (utilities.h:131-138).
    """
    r = jnp.sqrt(u1)
    theta = 2.0 * jnp.pi * u2
    x = r * jnp.cos(theta)
    y = r * jnp.sin(theta)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))
    return jnp.stack([x, y, z], axis=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta / jnp.pi


def make_onb(n):
    """Branchless orthonormal basis around unit normal n (..., 3).

    Duff et al. 2017 "Building an Orthonormal Basis, Revisited" — no
    per-lane control flow, vectorizes cleanly.
    """
    z = n[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], axis=-1
    )
    bvec = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, bvec


def local_to_world(local, n):
    """Rotate local (+z = normal) directions into the world frame."""
    t, b = make_onb(n)
    return (
        local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n
    )


def normalize_dir(v):
    # Clamp inside the sqrt: zero-vector VJP must be 0, not NaN.
    return v / jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-24))


def reflect(d, n):
    """Mirror reflection of incident direction d about normal n."""
    return d - 2.0 * jnp.sum(d * n, axis=-1, keepdims=True) * n


def refract(d, n, eta):
    """Refraction of incident d through normal n with relative IOR eta.

    Returns (refracted_dir, total_internal_reflection_mask). d points into
    the surface; n faces against d (dot(d, n) <= 0).
    """
    cos_i = -jnp.sum(d * n, axis=-1, keepdims=True)
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t[..., 0] >= 1.0
    # Clamp strictly above 0: sqrt'(0) = inf would NaN the VJP on TIR lanes
    # (inf × zero-cotangent); TIR lanes are masked out anyway.
    cos_t = jnp.sqrt(jnp.clip(1.0 - sin2_t, 1e-12, 1.0))
    refr = eta * d + (eta * cos_i - cos_t) * n
    return refr, tir


def fresnel_schlick(cos_i, eta_i, eta_t):
    """Schlick's Fresnel reflectance approximation."""
    r0 = ((eta_i - eta_t) / (eta_i + eta_t)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_i) ** 5


def pixel_sample_key(base_key, pixel_idx, sample_idx):
    """Per-(pixel, sample) keys; bounce-level randomness folds in further.

    vmappable: pixel_idx (R,) int32, sample_idx scalar. Layout-invariant —
    the key depends only on logical pixel/sample ids, never on sharding,
    which is the basis of the multi-host determinism guarantee (SURVEY.md §4.5).
    """
    k = jax.random.fold_in(base_key, sample_idx)
    return jax.vmap(lambda p: jax.random.fold_in(k, p))(pixel_idx)


# --- pluggable path samplers -------------------------------------------------
#
# The integrator draws its per-lane randomness through a three-function
# sampler interface so the RNG engine is swappable without touching the
# estimator: ``path_keys`` (per-(pixel, sample) state), ``fold`` (derive a
# decorrelated stream), ``uniform`` (n floats in [0,1) per lane). Both engines
# are counter-based and depend only on LOGICAL ids (seed, pixel, sample,
# stream), never on array layout — the multi-host determinism contract.
#
# KEY DISCIPLINE (same as jax.random's): keys are single-use. Every
# ``uniform`` call site must first derive a fresh stream with ``fold(keys,
# site_constant)`` — calling ``uniform`` twice on the SAME key returns the
# SAME values for BOTH engines (one deterministic evaluation per key; for
# pcg that is one PCG4D mix, for threefry one counter block). There is no
# hidden draw counter, by design: statelessness is what makes sample
# sequences layout/shard/replay-invariant.
#
# - "pcg": PCG4D hash (Jarzynski & Olano, "Hash Functions for GPU Rendering",
#   JCGT 2020) — ~12 integer vector ops per 4 lanes of output, elementwise
#   with no per-lane vmap. The default: threefry's 20-round Feistel is far
#   more work per draw, and a frame has 3-5 draw sites per bounce.
# - "threefry": jax.random (threefry2x32) — the crypto-strength engine kept
#   for A/B validation (tests compare estimator means across engines).


def pcg4d(v: jnp.ndarray) -> jnp.ndarray:
    """PCG4D mixing function over uint32 lanes: (..., 4) -> (..., 4)."""
    v = v * jnp.uint32(1664525) + jnp.uint32(1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x, y, z, w = (a ^ (a >> jnp.uint32(16)) for a in (x, y, z, w))
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], axis=-1)


_GOLDEN = jnp.uint32(0x9E3779B9)  # odd multiplier: fold chains stay injective


def _uniform_from_bits(bits: jnp.ndarray) -> jnp.ndarray:
    # Top 24 bits → [0, 1) with full float32 mantissa coverage.
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


class PcgSampler:
    """Stateless counter-based sampler: state rows are (seed, pixel, sample,
    stream) uint32 words; every draw is one PCG4D evaluation."""

    @staticmethod
    def path_keys(base_key, pixel_idx, sample_idx):
        kd = base_key
        if jnp.issubdtype(jnp.asarray(kd).dtype, jax.dtypes.prng_key):
            kd = jax.random.key_data(kd)
        kd = jnp.asarray(kd).astype(jnp.uint32).reshape(-1)
        seed = kd[-1] + kd[0] * jnp.uint32(2654435761)
        r = pixel_idx.shape[0]
        return jnp.stack(
            [
                jnp.broadcast_to(seed, (r,)),
                pixel_idx.astype(jnp.uint32),
                jnp.broadcast_to(jnp.uint32(sample_idx), (r,)),
                jnp.zeros((r,), jnp.uint32),
            ],
            axis=-1,
        )

    @staticmethod
    def fold(keys, c):
        assert keys.shape[-1] == 4, f"pcg keys are (..., 4) uint32, got {keys.shape}"
        stream = keys[..., 3] * _GOLDEN + jnp.asarray(c).astype(jnp.uint32)
        return jnp.concatenate([keys[..., :3], stream[..., None]], axis=-1)

    @staticmethod
    def uniform(keys, n: int):
        """n ≤ 4 floats in [0,1) per lane — ONE PCG4D eval of the key.
        Single-use keys: fold a fresh stream before every call (see the
        KEY DISCIPLINE note above); repeated calls on one key repeat."""
        assert keys.shape[-1] == 4, f"pcg keys are (..., 4) uint32, got {keys.shape}"
        assert 1 <= n <= 4, "one PCG4D draw yields at most 4 words"
        return _uniform_from_bits(pcg4d(keys)[..., :n])


class ThreefrySampler:
    """jax.random engine behind the same interface (keys: (R,) PRNG keys)."""

    path_keys = staticmethod(pixel_sample_key)

    @staticmethod
    def fold(keys, c):
        return jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys, c)

    @staticmethod
    def uniform(keys, n: int):
        return jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)


SAMPLERS = {"pcg": PcgSampler, "threefry": ThreefrySampler}


def make_sampler(impl: str):
    try:
        return SAMPLERS[impl]
    except KeyError:
        raise ValueError(f"unknown rng impl {impl!r}; expected one of {sorted(SAMPLERS)}")


def path_keys(seed: int, ids: jnp.ndarray, sample_idx: int = 0, impl: str = "pcg"):
    """Convenience: per-lane path keys for direct trace_paths callers/tests."""
    return make_sampler(impl).path_keys(jax.random.PRNGKey(seed), ids, sample_idx)
