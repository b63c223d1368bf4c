"""Top-level renderer: camera + scene + settings → image.

Replaces the reference's frame loop (kernel.cu:331-359): one jitted function
renders a full frame — ray generation (models/camera.py), a sample loop
(`lax.scan` over spp), the wavefront bounce integrator, and film
accumulation. No GL/GLFW — output is a host-side array written to
PPM/PNG (utils/image.py), per SURVEY.md §1's mapping of layer L5.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from gpupathtracer_tpu.models.camera import Camera, generate_rays, generate_rays_for_pixels
from gpupathtracer_tpu.models.scene import TriangleScene
from gpupathtracer_tpu.ops import sampling
from gpupathtracer_tpu.render.integrator import IntegratorOptions, normal_aov, trace_paths


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Render block of the config schema (SURVEY.md §5 config system)."""

    width: int = 800  # kernel.cu:262
    height: int = 800  # kernel.cu:263
    spp: int = 1  # kernel.cu:266
    bounces: int = 1  # committed reference executes exactly one bounce
    seed: int = 1234  # the reference's curand seed (utilities.h:118)
    jitter: bool = True  # sub-pixel AA for spp > 1; False bit-matches kernel.cu:200-201
    background: tuple = (0.0, 0.0, 0.0)
    aov: str = "radiance"  # "radiance" | "normal" | "normal_unit"
    rr_start: int | None = None
    # Triangle block width of the plucker/brute scans and the scene's row
    # padding (the Pallas kernel packs at its own pallas_intersect.TRI_BLOCK).
    tri_block: int = 128
    ray_chunk: int = 8192
    use_shading_normals: bool = False
    intersector: str = "auto"  # see IntegratorOptions.intersector
    estimator: str = "naive"  # "naive" (reference design) | "nee" | "mis" (balance heuristic)
    # Per-call ray sorting for bounce coherence (pallas backend only); see
    # IntegratorOptions.sort_rays. "auto" = on when the resolved intersector
    # culls (the Pallas kernel) and the scene has at least
    # SORT_RAYS_MIN_TRIANGLES packed rows; off otherwise. Explicit
    # True/False always wins.
    sort_rays: bool | str = "auto"
    # "dir" | "origin" | "auto" (→ "origin" where sort_rays auto turns on,
    # "dir" otherwise); see IntegratorOptions.sort_key.
    sort_key: str = "auto"
    compact: bool = True  # dead-lane compaction (see IntegratorOptions.compact)
    compact_mode: str = "permute"  # "permute" | "mask" | "hybrid" (see IntegratorOptions)
    rng: str = "pcg"  # per-lane RNG engine: "pcg" | "threefry" (see IntegratorOptions)
    # Static BxdfType values present in the scene (see IntegratorOptions.
    # material_set). render_frame/render_samples narrow this automatically
    # for concrete scenes; absent material branches then compile away.
    material_set: tuple = (0, 1, 2, 3)
    # Textured diffuse albedo (checker / image via hit UVs); auto-enabled by
    # narrow_settings when a concrete scene's live materials use textures.
    textured: bool = False


def _integrator_options(s: RenderSettings) -> IntegratorOptions:
    if not isinstance(s.sort_rays, bool) or s.sort_key == "auto":
        # "auto" still unresolved here ⇒ even the scene's STRUCTURE fields
        # were traced (narrow_settings couldn't inspect liveness) — fall
        # back to the resident-scene defaults, observably (VERDICT r4
        # item 8: silent perf degradations must show up in the JSONL).
        from gpupathtracer_tpu.utils.metrics import log_runtime_event

        log_runtime_event(
            {
                "event": "auto_fallback",
                "what": "sort_rays/sort_key",
                "resolved": {"sort_rays": False, "sort_key": "dir"},
                "why": "scene structure traced; resident-scene defaults used",
            },
            once_key="auto_fallback:sort",
        )
    return IntegratorOptions(
        bounces=s.bounces,
        background=s.background,
        rr_start=s.rr_start,
        tri_block=s.tri_block,
        ray_chunk=s.ray_chunk,
        use_shading_normals=s.use_shading_normals,
        material_set=s.material_set,
        intersector=s.intersector,
        estimator=s.estimator,
        sort_rays=s.sort_rays if isinstance(s.sort_rays, bool) else False,
        sort_key=s.sort_key if s.sort_key != "auto" else "dir",
        compact=s.compact,
        compact_mode=s.compact_mode,
        rng=s.rng,
        textured=s.textured,
    )


def scene_material_set(scene: TriangleScene) -> tuple:
    """Static BxdfType set referenced by the scene's live triangles (EP
    specialization input, IntegratorOptions.material_set). Concrete scenes
    only — do not call on tracers."""
    import numpy as np

    types = np.asarray(scene.materials.type)
    mat_id = np.asarray(scene.mat_id)
    valid = np.asarray(scene.valid)
    used = np.unique(mat_id[valid]) if valid.any() else np.unique(mat_id)
    return tuple(sorted({int(t) for t in types[used]}))


_FULL_MATERIAL_SET = (0, 1, 2, 3)

# Packed-row count from which the sort autos turn coherence sorting on for a
# culling intersector: one argsort + gathers per bounce buys tighter tile
# frustums, which pays only once a scene has many blocks to cull. The value
# carries over the scale at which sorting paid on the earlier hardware; it
# has not been measured on the H100 yet.
SORT_RAYS_MIN_TRIANGLES = 52_429


def _all_concrete(*xs) -> bool:
    return not any(isinstance(x, jax.core.Tracer) for x in xs)


def narrow_settings(scene: TriangleScene, settings: RenderSettings) -> RenderSettings:
    """Auto-narrow ``settings.material_set`` to the types a concrete scene's
    live triangles reference (the EP-analogue specialization — absent
    branches compile away, bit-identical images).

    Narrowing only fires when the set is still the full default, so a caller
    who pins an explicit set — e.g. the full (0,1,2,3) to keep one compiled
    executable across scenes, or a superset for an A/B of the specialization
    — is respected. Shared by render_frame / render_samples /
    parallel.render_frame_distributed so the rule lives in one place.

    Also flips ``textured`` on when any live material references a texture
    (never off — a caller-set True is respected for traced-texture setups).

    Each resolution needs only ITS fields concrete — in grad mode (traced
    geometry/materials under ``jax.grad``) the structure fields (``valid``,
    ``two_sided``, ``mat_id``, ``materials.type``) are closure constants,
    so the sort autos and the material-set narrowing still fire.
    """
    import numpy as np

    if (
        not settings.textured
        and _all_concrete(scene.mat_id, scene.valid, scene.materials.tex_kind)
    ):
        mat_id = np.asarray(scene.mat_id)[np.asarray(scene.valid)]
        used = np.unique(mat_id) if mat_id.size else np.arange(0)
        if (np.asarray(scene.materials.tex_kind)[used] > 0).any():
            settings = dataclasses.replace(settings, textured=True)
    if (settings.sort_rays == "auto" or settings.sort_key == "auto") and _all_concrete(
        scene.valid, scene.two_sided
    ):
        # Resolve the coherence-sort autos from whether the intersector
        # culls per ray tile (only the Pallas kernel does) and from the
        # scene's packed row count (two-sided rows are duplicated).
        from gpupathtracer_tpu.render.integrator import resolved_intersector

        culls = resolved_intersector(IntegratorOptions(intersector=settings.intersector)) == "pallas"
        valid = np.asarray(scene.valid)
        rows = int(valid.sum() + (np.asarray(scene.two_sided) & valid).sum())
        large = culls and rows >= SORT_RAYS_MIN_TRIANGLES
        if settings.sort_rays == "auto":
            settings = dataclasses.replace(settings, sort_rays=large)
        if settings.sort_key == "auto":
            settings = dataclasses.replace(
                settings, sort_key="origin" if large else "dir"
            )
    if tuple(settings.material_set) == _FULL_MATERIAL_SET and _all_concrete(
        scene.mat_id, scene.valid, scene.materials.type
    ):
        settings = dataclasses.replace(settings, material_set=scene_material_set(scene))
    return settings


def render_frame(
    scene: TriangleScene,
    camera: Camera,
    settings: RenderSettings,
    seed: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Render a full frame; returns mean radiance (H, W, 3) float32.

    Jitted once per (resolution, spp, bounces, aov) combination; scene,
    camera, and the RNG seed are traced arguments so parameter/seed updates
    don't recompile (``seed=None`` uses ``settings.seed``).

    ``intersector="bvh"`` builds the flattened BVH host-side (the scene must
    be concrete — i.e. call this outside jit) and passes it to the jitted
    core as a traced pytree, so camera/material/seed updates reuse the
    compiled executable and the BVH rebuilds only when geometry changes.

    The Pallas backend gets the same treatment: when the scene's STRUCTURE
    (``valid``/``two_sided``) is concrete the scene is packed here, outside
    the jitted core — fully-concrete scenes pack eagerly once and CACHE
    across frames (ops/pallas_intersect pack cache); grad-mode scenes
    (traced geometry, concrete liveness) get the same trimmed row set with
    traced values, instead of the 2×-block static-shape fallback. Only a
    fully-traced scene (structure included) takes the traced full-copy pack
    inside ``_render_frame_core``.
    """
    concrete = not isinstance(scene.v0, jax.core.Tracer)
    settings = narrow_settings(scene, settings)
    if settings.intersector == "bvh" and concrete:
        return _render_frame_bvh(scene, _cached_bvh(scene), camera, settings, seed)
    from gpupathtracer_tpu.render.integrator import resolved_intersector

    if _all_concrete(scene.valid, scene.two_sided) and (
        resolved_intersector(_integrator_options(settings)) == "pallas"
    ):
        from gpupathtracer_tpu.ops.pallas_intersect import pack_scene

        packed = pack_scene(scene)
        return _render_frame_prepacked(scene, packed, camera, settings, seed)
    return _render_frame_core(scene, camera, settings, seed)


def _frame_body(scene, camera, settings, seed, intersect_fn, packed=None):
    h, w = settings.height, settings.width
    assert camera.width == w and camera.height == h, "camera/screen size mismatch"
    opts = _integrator_options(settings)

    if settings.aov in ("normal", "normal_unit"):
        o, d = generate_rays(camera)
        color = normal_aov(
            scene, o, d, opts, reference_parity=settings.aov == "normal",
            intersect_fn=intersect_fn,
        )
        return color.reshape(h, w, 3)

    r = h * w
    pixel_idx = jnp.arange(r, dtype=jnp.uint32)
    base_key = jax.random.PRNGKey(settings.seed if seed is None else seed)
    film_sum = accumulate_radiance(
        scene, camera, pixel_idx, settings, base_key, intersect_fn, packed=packed,
    )
    return (film_sum / settings.spp).reshape(h, w, 3)


@partial(jax.jit, static_argnames=("settings",))
def _render_frame_core(
    scene: TriangleScene,
    camera: Camera,
    settings: RenderSettings,
    seed: jnp.ndarray | None = None,
) -> jnp.ndarray:
    from gpupathtracer_tpu.render.integrator import make_intersect_fn

    intersect_fn = make_intersect_fn(scene, _integrator_options(settings))
    return _frame_body(scene, camera, settings, seed, intersect_fn)


@partial(jax.jit, static_argnames=("settings",))
def _render_frame_prepacked(scene, packed, camera, settings, seed=None):
    from gpupathtracer_tpu.render.integrator import make_intersect_fn

    intersect_fn = make_intersect_fn(scene, _integrator_options(settings), packed=packed)
    return _frame_body(scene, camera, settings, seed, intersect_fn, packed=packed)


# BVH identity cache (same contract as the pack cache in
# ops/pallas_intersect): repeated frames on unchanged geometry reuse the
# host-built flattened BVH instead of rebuilding per call. Weakrefs guard
# id() recycling.
_BVH_CACHE: dict = {}
_BVH_CACHE_ORDER: list = []
_BVH_CACHE_SIZE = 4


def _cached_bvh(scene: TriangleScene):
    import weakref

    from gpupathtracer_tpu.accel.bvh import build_bvh

    fields = (scene.v0, scene.e1, scene.e2, scene.valid)
    key = tuple(id(x) for x in fields)
    entry = _BVH_CACHE.get(key)
    if entry is not None and all(r() is f for r, f in zip(entry[0], fields)):
        _BVH_CACHE_ORDER.remove(key)
        _BVH_CACHE_ORDER.append(key)
        return entry[1]
    _BVH_CACHE.pop(key, None)
    bvh = build_bvh(scene)
    try:
        refs = tuple(weakref.ref(x) for x in fields)
    except TypeError:
        return bvh
    _BVH_CACHE[key] = (refs, bvh)
    if key in _BVH_CACHE_ORDER:
        _BVH_CACHE_ORDER.remove(key)
    _BVH_CACHE_ORDER.append(key)
    while len(_BVH_CACHE_ORDER) > _BVH_CACHE_SIZE:
        old = _BVH_CACHE_ORDER.pop(0)
        _BVH_CACHE.pop(old, None)
    return bvh


@partial(jax.jit, static_argnames=("settings",))
def _render_frame_bvh(scene, bvh, camera, settings, seed=None):
    from gpupathtracer_tpu.accel.bvh import intersect_bvh

    intersect_fn = lambda o, d, s: intersect_bvh(o, d, s, bvh)
    return _frame_body(scene, camera, settings, seed, intersect_fn)


def accumulate_radiance(
    scene, camera, pixel_idx, settings, base_key, intersect_fn,
    sample_start=0, num_samples=None, packed=None,
):
    """Sum of per-sample radiance for the given pixels (spp loop, `lax.scan`).

    ``pixel_idx`` identifies which logical pixels these lanes are — sample
    keys depend only on (base_key, pixel id, *global* sample id), so a
    sharded caller (parallel/render.py) passing each device its pixel slice
    reproduces the single-device sample sequences bit-exactly
    (layout-invariant RNG, SURVEY.md §4.5), and a progressive caller
    (render/progressive.py) accumulating sample ranges [start, start+n) is
    bit-exact with a one-shot render of the union — the basis of
    sample-exact checkpoint/resume.
    """
    opts = _integrator_options(settings)
    sampler = sampling.make_sampler(settings.rng)
    r = pixel_idx.shape[0]
    n = settings.spp if num_samples is None else num_samples

    def sample_step(film_sum, s):
        keys = sampler.path_keys(base_key, pixel_idx, s)
        if settings.jitter and settings.spp > 1:
            jitter_uv = sampler.uniform(sampler.fold(keys, 0xA11A), 2)
        else:
            jitter_uv = None
        o, d = generate_rays_for_pixels(camera, pixel_idx, jitter_uv)
        radiance = trace_paths(
            scene, o, d, keys, opts, intersect_fn=intersect_fn, packed=packed
        )
        return film_sum + radiance, None

    film_sum, _ = jax.lax.scan(
        sample_step, jnp.zeros((r, 3), jnp.float32), sample_start + jnp.arange(n)
    )
    return film_sum


def render_samples(
    scene: TriangleScene,
    camera: Camera,
    settings: RenderSettings,
    sample_start: jnp.ndarray,
    num_samples: int,
    seed: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Radiance SUM over global samples [start, start+num) — (H, W, 3).

    The progressive/checkpointed entry point: summing chunk outputs over a
    partition of [0, spp) is bit-identical to ``render_frame * spp``.
    Concrete-structure scenes get the trimmed/cached pack fast path (see
    render_frame).
    """
    from gpupathtracer_tpu.render.integrator import resolved_intersector

    packed = None
    settings = narrow_settings(scene, settings)
    if _all_concrete(scene.valid, scene.two_sided):
        if resolved_intersector(_integrator_options(settings)) == "pallas":
            from gpupathtracer_tpu.ops.pallas_intersect import pack_scene

            packed = pack_scene(scene)
    return _render_samples_core(
        scene, packed, camera, settings, sample_start, num_samples, seed
    )


@partial(jax.jit, static_argnames=("settings", "num_samples"))
def _render_samples_core(
    scene, packed, camera, settings, sample_start, num_samples: int, seed=None
):
    h, w = settings.height, settings.width
    pixel_idx = jnp.arange(h * w, dtype=jnp.uint32)
    base_key = jax.random.PRNGKey(settings.seed if seed is None else seed)
    from gpupathtracer_tpu.render.integrator import make_intersect_fn

    intersect_fn = make_intersect_fn(scene, _integrator_options(settings), packed=packed)
    film = accumulate_radiance(
        scene, camera, pixel_idx, settings, base_key, intersect_fn,
        sample_start=sample_start, num_samples=num_samples, packed=packed,
    )
    return film.reshape(h, w, 3)


def render(scene: TriangleScene, camera: Camera, settings: RenderSettings):
    """Convenience wrapper: returns the frame as a host numpy array."""
    import numpy as np

    return np.asarray(jax.device_get(render_frame(scene, camera, settings)))
