"""Wavefront Monte Carlo path-tracing integrator (`lax.scan` over bounces).

This realizes the reference README's intended loop — "per bounce: generate
rays, intersect, accumulate color, shade" (readme.md "Mega Kernel method";
only one bounce of it is committed, kernel.cu:207-215) — as the *wavefront*
formulation the reference explicitly considered and deferred (its unused
``d_raysToTrace`` compaction buffer, kernel.cu:300-302). Per-bounce stages
are dense vector ops over the whole ray batch with masked liveness, no
per-lane divergence.

Estimator: naive path tracing (emitter-hit accumulation, no next-event
estimation — matching the reference design), with cosine-weighted Lambertian
sampling. The reference's latent shading code returns
``albedo * |dot(n, incoming)|`` with pdf ``cos/π`` (utilities.h:109-138) —
dimensionally incoherent half-finished code (see PARITY.md); we implement the
*intended* physically based estimator: for cosine-weighted sampling the
Lambertian throughput factor is exactly ``albedo``
((albedo/π)·cosθ / (cosθ/π) = albedo).

Materials: all four reference BXDF types (utilities.h:68-75) — EMITTER
(two-sided Le = emissive·intensity, utilities.h:96-103), DIFFUSE, plus the
declared-but-unimplemented MIRROR (perfect specular) and GLASS (Schlick
Fresnel dielectric). Dispatch is dense masked selection over the small
material set — the wavefront analogue of material sorting (SURVEY.md §2.4 EP row).

Termination: fixed bounce count (static scan length), optional Russian
roulette masking after ``rr_start`` bounces. Rays that die (miss / emitter /
roulette) carry zero throughput; their lanes keep executing harmlessly —
liveness is data, not shape (XLA static-shape discipline).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from gpupathtracer_tpu.models.materials import BxdfType
from gpupathtracer_tpu.models.scene import TriangleScene
from gpupathtracer_tpu.ops import sampling
from gpupathtracer_tpu.ops.intersect import Hit, intersect_brute, resolve_hits

# Offset applied along the oriented normal when spawning secondary rays; the
# reference has no such machinery yet (SURVEY.md §2.3.12) — it relies on the
# t > 1e-6 epsilon alone, which we also honor (ops/intersect.py t_min).
RAY_OFFSET = 1e-4


@dataclasses.dataclass(frozen=True)
class IntegratorOptions:
    bounces: int = 4
    background: tuple = (0.0, 0.0, 0.0)  # committed reference: memset black (kernel.cu:340)
    rr_start: int | None = None  # Russian roulette from this bounce; None = off
    tri_block: int = 128
    ray_chunk: int = 8192
    use_shading_normals: bool = False  # reference shades with geometric normals
    # Intersection backend: "auto" = the Pallas kernel on a GPU, the jnp
    # Plücker scan elsewhere; "brute" = the Möller–Trumbore oracle; explicit
    # "pallas" / "plucker" / "bvh" force a backend ("pallas" off a GPU is an
    # error, see resolved_intersector).
    intersector: str = "auto"
    # Estimator: "naive" = emitter-hit accumulation only (the reference
    # README's design); "nee" = next-event estimation (explicit light
    # sampling); "mis" = NEE + BSDF samples combined with the balance
    # heuristic (one sample from each strategy per diffuse vertex). NEE
    # converges far faster AND is what makes geometry gradients nonzero
    # under detached sampling: its cosθ_x·cosθ_y/r² term is differentiable
    # wrt vertices/normals, whereas naive PT's path contributions are
    # products of constants (see grad/). MIS additionally keeps variance
    # bounded when the light subtends a large solid angle (where pure NEE's
    # cos·cos/r² term is wild) — the production default.
    estimator: str = "naive"
    # Sort rays for tile coherence: standalone (octant, Morton) wrapper when
    # compaction is off, or folded into the compaction permutation
    # (compact_rays_coherent) when it's on. Only the culling kernel gains
    # from it; default off (RenderSettings "auto" turns it on for large
    # scenes, see renderer.narrow_settings).
    sort_rays: bool = False
    # Sort-key layout for the coherence permutation (see ops/compaction.py
    # compact_rays_coherent): "dir" (octant-major — open scenes, long rays)
    # or "origin" (origin-Morton-major, octant minor — dense/closed scenes
    # where secondary rays terminate nearby; keeps per-block entry keys
    # meaningful so front-to-back early exit fires). Bit-identical images.
    sort_key: str = "dir"
    # Dead-lane compaction: make dead lanes (miss / emitter / roulette) cost
    # ~nothing at the intersection kernel — wavefront compaction under static
    # shapes. Effective with the Pallas backend only (tile-level culling);
    # auto-gated on it.
    compact: bool = True
    # How: "permute" (default, ops/compaction.py) alive-first-permutes rays
    # and parks dead lanes outside the scene — gathers and scatters per
    # bounce, but live lanes pack into the fewest possible tiles. "mask"
    # passes the live mask into the kernel's frustum pre-pass instead (dead
    # lanes excluded from tile bounds, best_t = -inf in-kernel): ZERO data
    # movement, but live lanes stay spread across tiles and each partially-
    # live tile pays the full block traversal, so it wins only when liveness
    # is tile-coherent. "hybrid" permutes the FULL path state once after
    # bounce 0 (the big death wave: misses + emitter hits) and runs every
    # later bounce in mask mode on the packed order. Images are bit-identical
    # across all three modes (per-lane results don't depend on tiling).
    compact_mode: str = "permute"
    # Static set of BxdfType values present in the scene (EP-analogue
    # specialization): the dense masked-select shading evaluates EVERY
    # material branch full-width, so absent types are pure ALU/memory waste —
    # render_frame narrows this to the types the concrete scene's live
    # triangles actually reference, and the absent branches compile away.
    # Lanes of absent types cannot exist, so images are bit-identical to
    # the full set. Default: all four (safe for traced scenes).
    material_set: tuple = (0, 1, 2, 3)
    # Per-lane RNG engine (ops/sampling.py SAMPLERS): "pcg" (PCG4D hash —
    # one elementwise integer mix per draw site, the default) or
    # "threefry" (jax.random; kept for estimator A/B validation). Both are
    # counter-based over logical (seed, pixel, sample, stream) ids —
    # layout/shard-invariant.
    rng: str = "pcg"
    # Textured diffuse albedo (models/materials.py::textured_albedo): when
    # True, hit UVs are resolved (need_uv) and diffuse albedo comes from
    # the material's checker/image texture. Static so untextured scenes pay
    # nothing (the UV interpolation + texture gathers compile away);
    # renderer.narrow_settings flips it on automatically when a concrete
    # scene's live materials reference a texture.
    textured: bool = False


def resolved_intersector(options: IntegratorOptions) -> str:
    """The backend an option resolves to on this platform.

    "auto" picks the Pallas kernel where its route compiles (a GPU) and the
    XLA Plücker scan elsewhere. An explicit "pallas" off a GPU is an error,
    not a silent interpreter run (tests opt in to the interpreter through
    ``pallas_intersect.INTERPRET``).
    """
    from gpupathtracer_tpu.ops import pallas_intersect

    which = options.intersector
    if which == "auto":
        return "pallas" if pallas_intersect.kernel_available() else "plucker"
    if which == "pallas" and not (
        pallas_intersect.kernel_available() or pallas_intersect.INTERPRET
    ):
        raise ValueError(
            "intersector='pallas' needs a GPU (the kernel's Triton route); "
            f"backend is {jax.default_backend()!r}"
        )
    return which


def make_intersect_fn(scene: TriangleScene, options: IntegratorOptions, packed=None):
    """Build the closest-hit function for the configured backend.

    Packs the scene once (hoisted out of the bounce/sample loops under jit).
    ``packed``: an eagerly pre-packed PackedScene (render_frame's concrete
    fast path) — skips the traced re-pack, whose static-shape discipline
    must append a full flipped copy (2× blocks for one-sided meshes).
    """
    from gpupathtracer_tpu.ops import pallas_intersect, plucker

    which = resolved_intersector(options)
    if which == "brute":
        return partial(intersect_brute, tri_block=options.tri_block, ray_chunk=options.ray_chunk)
    if which == "plucker":
        packed = plucker.pack_triangles(scene, tri_block=options.tri_block)
        return lambda o, d, _scene: plucker.intersect_plucker_jnp(
            o, d, packed, ray_chunk=options.ray_chunk
        )
    if which == "pallas":
        if packed is None:
            packed = pallas_intersect.pack_scene(scene)
        base = lambda o, d, _scene, alive=None: pallas_intersect.intersect_pallas(
            o, d, packed, alive=alive
        )
        # Mask-based compaction: the integrator passes the live mask straight
        # into the kernel's frustum pre-pass (see IntegratorOptions.compact_mode).
        base.supports_alive = True
        if options.sort_rays and not options.compact:
            # With compaction on, coherence comes from the combined
            # compact+sort permutation (compact_rays_coherent) instead —
            # one argsort, not two.
            return pallas_intersect.make_sorted_intersect(
                base, packed, key_mode=options.sort_key
            )
        return base
    raise ValueError(f"unknown intersector {options.intersector!r}")


def make_occlusion_fn(
    scene: TriangleScene,
    options: IntegratorOptions,
    intersect_fn,
    allow_kernel: bool = True,
    packed=None,
):
    """Build ``occluded(o, d, max_t) -> bool``: ∃ accepted hit with t < max_t.

    Pallas scenes get the kernel's any-hit mode (first-hit exit per lane,
    tile exit once every lane is done); every other backend thresholds the
    closest hit — the SAME
    predicate (min accepted t < max_t ⇔ ∃ accepted t < max_t), so images
    are backend-independent. ``allow_kernel=False`` forces the threshold
    path (used with caller-supplied intersectors, e.g. the scene-sharded
    distributed sweeps, where the full-scene kernel would defeat the
    sharding).
    """
    if allow_kernel and resolved_intersector(options) == "pallas":
        from gpupathtracer_tpu.ops import pallas_intersect

        if packed is None:
            packed = pallas_intersect.pack_scene(scene)
        return lambda o, d, mt: pallas_intersect.intersect_pallas_occluded(
            o, d, mt, packed
        )

    def fallback(o, d, mt):
        # Thresholded closest hit. Lanes with mt = 0 need no testing — pass
        # them as dead to backends that support the alive mask (the Pallas
        # kernel's zero-copy tile cull).
        if getattr(intersect_fn, "supports_alive", False):
            h = intersect_fn(o, d, scene, alive=mt > 0)
        else:
            h = intersect_fn(o, d, scene)
        return h.hit & (h.t < mt)

    return fallback


def _gather_materials(scene: TriangleScene, mat_id, textured: bool = False):
    """Per-ray material attributes via ONE row gather.

    The material table is tiny (a handful of rows); packing its scalars
    into one (M, 15|21) matrix turns the per-field 640k-lane gathers per
    bounce into a single row gather plus free slicing. The texture columns
    (kind, id, checker color/scale) ride along only when ``textured``.
    """
    m = scene.materials
    cols = [
        m.type.astype(jnp.float32)[:, None],
        m.albedo,
        m.specular_color,
        m.refractive_index[:, None],
        m.emissive_color,
        m.intensity[:, None],
        m.transmittance_color,
    ]
    if textured:
        cols += [
            m.tex_kind.astype(jnp.float32)[:, None],
            m.tex_id.astype(jnp.float32)[:, None],
            m.checker_color,
            m.checker_scale[:, None],
        ]
    table = jnp.concatenate(cols, axis=-1)  # (M, 15 [+6])
    g = table[mat_id]  # (R, 15 [+6])
    out = {
        "type": g[:, 0].astype(jnp.int32),
        "albedo": g[:, 1:4],
        "specular": g[:, 4:7],
        "ior": g[:, 7],
        "emissive": g[:, 8:11],
        "intensity": g[:, 11],
        "transmittance": g[:, 12:15],
    }
    if textured:
        out.update(
            tex_kind=g[:, 15].astype(jnp.int32),
            tex_id=g[:, 16].astype(jnp.int32),
            checker_color=g[:, 17:20],
            checker_scale=g[:, 20],
        )
    return out


def init_path_state(origins, directions, keys):
    """Initial wavefront state tuple for make_bounce_fn's step function."""
    r = origins.shape[0]
    return (
        origins,
        directions,
        jnp.ones((r, 3), jnp.float32),  # throughput
        jnp.zeros((r, 3), jnp.float32),  # radiance
        jnp.ones((r,), jnp.bool_),  # alive
        jnp.zeros((r,), jnp.bool_),  # prev_nee: camera vertex does no NEE
        jnp.zeros((r,), jnp.float32),  # prev_pdf
        keys,
    )


def dead_path_state(r: int, keys):
    """An inert state: no lane alive, every bounce application is a no-op —
    what pipeline stages hold before their first microbatch arrives."""
    return (
        jnp.zeros((r, 3), jnp.float32),
        jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (r, 1)),
        jnp.zeros((r, 3), jnp.float32),
        jnp.zeros((r, 3), jnp.float32),
        jnp.zeros((r,), jnp.bool_),
        jnp.zeros((r,), jnp.bool_),
        jnp.zeros((r,), jnp.float32),
        keys,
    )


def make_bounce_fn(
    scene: TriangleScene,
    options: IntegratorOptions,
    intersect_fn=None,
    packed=None,
):
    """Build the single-bounce step ``bounce(state, bounce_idx) -> state``.

    The unit both the sequential scan (trace_paths) and the pipeline-
    parallel staged wavefront (parallel/pipeline.py) iterate: state is the
    8-tuple of init_path_state; per-lane results depend only on that lane's
    ray and key, so any batching/staging of lanes is estimator-invariant.
    """
    custom_intersect = intersect_fn is not None
    if intersect_fn is None:
        intersect_fn = make_intersect_fn(scene, options, packed=packed)
    sampler = sampling.make_sampler(options.rng)
    background = jnp.asarray(options.background, jnp.float32)
    mis = options.estimator == "mis"
    nee = options.estimator == "nee" or mis
    # Static material-type specialization (IntegratorOptions.material_set):
    # branches for absent types compile away entirely.
    ms = tuple(options.material_set)
    has_emit = BxdfType.EMITTER in ms
    has_diffuse = BxdfType.DIFFUSE in ms
    has_mirror = BxdfType.MIRROR in ms
    has_glass = BxdfType.GLASS in ms
    # NEE/MIS light sampling is dead weight without both an emitter to
    # sample and a diffuse vertex to sample from — skip the light table AND
    # the per-bounce shadow-ray kernel call.
    nee = nee and has_emit and has_diffuse
    mis = mis and has_emit and has_diffuse
    occlude_fn = (
        make_occlusion_fn(
            scene, options, intersect_fn, allow_kernel=not custom_intersect, packed=packed
        )
        if nee
        else None
    )

    if nee:
        # Area-weighted light table over emissive triangles (computed once,
        # hoisted out of the bounce scan under jit).
        tri_area = 0.5 * jnp.linalg.norm(jnp.cross(scene.e1, scene.e2), axis=-1)
        tri_is_light = (scene.materials.type[scene.mat_id] == BxdfType.EMITTER) & scene.valid
        light_w = tri_area * tri_is_light.astype(jnp.float32)
        total_light_area = jnp.sum(light_w)
        light_cdf = jnp.cumsum(light_w)

    do_compact = options.compact and resolved_intersector(options) == "pallas"

    mask_compact = (
        do_compact
        and options.compact_mode == "mask"
        and not options.sort_rays  # sort needs the physical permutation
        and getattr(intersect_fn, "supports_alive", False)
    )

    def masked_intersect(o, d, mask, compact_now=True) -> Hit:
        """Closest hit for lanes where mask holds; dead lanes are compacted
        away (tile-level cull) and report no hit. ``compact_now=False``
        skips the dead-lane machinery — the first bounce is all-alive and
        camera-coherent, so it is pure overhead there."""
        if not (do_compact and compact_now):
            h = intersect_fn(o, d, scene)
            return Hit(t=h.t, tri=h.tri, hit=h.hit & mask)
        if mask_compact:
            h = intersect_fn(o, d, scene, alive=mask)
            return Hit(t=h.t, tri=h.tri, hit=h.hit & mask)
        from gpupathtracer_tpu.ops.compaction import compact_rays, compact_rays_coherent

        compact = (
            partial(compact_rays_coherent, key_mode=options.sort_key)
            if options.sort_rays
            else compact_rays
        )
        o_c, d_c, inv = compact(o, d, mask)
        h = intersect_fn(o_c, d_c, scene)
        return Hit(t=h.t[inv], tri=h.tri[inv], hit=h.hit[inv] & mask)

    def masked_occluded(o, d, max_t, mask):
        """Shadow/visibility query: any accepted hit with t < max_t, for
        lanes where mask holds (others report unoccluded). Dead lanes carry
        max_t = 0 — the occlusion kernel excludes them from its frustums
        directly, so mask mode needs no permutation here either."""
        mt = jnp.where(mask, max_t, 0.0)
        if occlude_fn is None:
            h = masked_intersect(o, d, mask)
            return h.hit & (h.t < max_t)
        if not do_compact or mask_compact:
            return occlude_fn(o, d, mt) & mask
        from gpupathtracer_tpu.ops.compaction import DEAD_DIR, DEAD_ORIGIN, partition_alive

        perm, inv = partition_alive(mask)
        alive_c = mask[perm]
        o_c = jnp.where(alive_c[:, None], o[perm], jnp.asarray(DEAD_ORIGIN, o.dtype))
        d_c = jnp.where(alive_c[:, None], d[perm], jnp.asarray(DEAD_DIR, d.dtype))
        mt_c = jnp.where(alive_c, mt[perm], 0.0)
        return occlude_fn(o_c, d_c, mt_c)[inv] & mask

    textured = options.textured and has_diffuse

    def bounce(state, bounce_idx, compact_now=True):
        o, d, throughput, radiance, alive, prev_nee, prev_pdf, keys = state
        hit: Hit = masked_intersect(o, d, alive, compact_now)
        attrs = resolve_hits(
            o, d, scene, hit.tri,
            need_sn=options.use_shading_normals, need_uv=textured,
        )
        found = alive & hit.hit
        missed = alive & ~hit.hit

        # Miss: accumulate background and terminate (reference: PBO stays at
        # the memset value — black; pink noHitColor is exposed via options).
        radiance = radiance + jnp.where(missed[:, None], throughput * background[None, :], 0.0)

        mat = _gather_materials(scene, attrs.mat_id, textured=textured)
        if textured:
            # Effective diffuse albedo from the hit UV (checker / image
            # lookup) — the reference stores UVs it never consumes
            # (utilities.h:156-166); here they finally do work.
            from gpupathtracer_tpu.models.materials import textured_albedo

            albedo = textured_albedo(
                mat["albedo"], mat["tex_kind"], mat["tex_id"],
                mat["checker_color"], mat["checker_scale"],
                attrs.uv, scene.textures,
            )
        else:
            albedo = mat["albedo"]
        false_lanes = jnp.zeros_like(found)
        is_emit = (mat["type"] == BxdfType.EMITTER) if has_emit else false_lanes
        is_diffuse = (mat["type"] == BxdfType.DIFFUSE) if has_diffuse else false_lanes
        is_mirror = (mat["type"] == BxdfType.MIRROR) if has_mirror else false_lanes
        is_glass = (mat["type"] == BxdfType.GLASS) if has_glass else false_lanes

        # EMITTER: two-sided Le = emissive * intensity (utilities.h:96-103);
        # path terminates (reference sets outgoing = 0). Accounting depends
        # on whether the PREVIOUS vertex performed light sampling:
        # - naive: every emitter hit counts in full;
        # - nee: hits whose previous vertex did NEE (= was diffuse) are
        #   already covered by its light sample — count only hits arriving
        #   from the camera or a specular (non-NEE) vertex. Per-vertex, not
        #   whole-chain: diffuse→mirror→emitter energy is generated ONLY by
        #   BSDF sampling (the diffuse vertex's light sample is a different
        #   path) and must count in full;
        # - mis: hits from an NEE vertex count with the balance-heuristic
        #   weight pdf_bsdf / (pdf_bsdf + pdf_light(ω)) — the complement of
        #   the weight the light sample below carries.
        if has_emit:
            le = mat["emissive"] * mat["intensity"][:, None]
            if mis:
                # Solid-angle pdf the light sampler would assign to this hit:
                # area-uniform over emitters ⇒ t² / (cosθ_y · A_total).
                cos_y_hit = jnp.abs(jnp.sum(attrs.gn * d, axis=-1))
                t2 = attrs.t * attrs.t
                pdf_light_hit = t2 / jnp.maximum(cos_y_hit * total_light_area, 1e-12)
                w_bsdf = prev_pdf / jnp.maximum(prev_pdf + pdf_light_hit, 1e-12)
                emit_w = jnp.where(prev_nee, w_bsdf, 1.0)
                count_emit = found & is_emit
            else:
                emit_w = 1.0
                count_emit = (found & is_emit) & (~prev_nee if nee else True)
            radiance = radiance + jnp.where(
                count_emit[:, None], throughput * le * (emit_w[:, None] if mis else 1.0), 0.0
            )

        # Shading frame. One-sided triangles are always front hits (the
        # backface cull guarantees dot(d, gn) < 0); two-sided primitives get
        # their normal oriented against the incident ray for sampling.
        n = attrs.sn if options.use_shading_normals else attrs.gn
        facing = -jnp.sign(jnp.sum(d * n, axis=-1, keepdims=True))
        n_shade = n * jnp.where(facing == 0.0, 1.0, facing)

        # Per-bounce randomness: counter-based fold-in, layout-invariant.
        kb = sampler.fold(keys, bounce_idx)
        u = sampler.uniform(kb, 3)

        if nee:
            # Next-event estimation: sample a point on an emissive triangle
            # (area-proportional), cast a shadow ray, add
            # throughput · (albedo/π) · Le · cosθ_x·cosθ_y / r² · A_total.
            # The cos·cos/r² geometry term is differentiable wrt vertices —
            # the path that makes inverse geometry (config 5) work.
            kl = sampler.fold(kb, 0x11EE)
            ul = sampler.uniform(kl, 3)
            pick = jnp.searchsorted(light_cdf, ul[:, 0] * total_light_area, side="right")
            pick = jnp.clip(pick, 0, scene.num_triangles - 1).astype(jnp.int32)
            su = jnp.sqrt(ul[:, 1])
            b1 = su * (1.0 - ul[:, 2])
            b2 = su * ul[:, 2]
            y = scene.v0[pick] + b1[:, None] * scene.e1[pick] + b2[:, None] * scene.e2[pick]
            # Sanitize missed lanes (their resolved point is meaningless and
            # can be huge): keep forward residuals finite so VJPs stay clean.
            x = jnp.where(found[:, None], attrs.point, o)
            wi_raw = y - x
            dist2 = jnp.maximum(jnp.sum(wi_raw * wi_raw, axis=-1), 1e-12)
            dist = jnp.sqrt(dist2)
            wi = wi_raw / dist[:, None]
            cos_x = jnp.sum(n_shade * wi, axis=-1)
            n_y = scene.gn[pick]
            cos_y = jnp.abs(jnp.sum(n_y * wi, axis=-1))  # two-sided lights
            shadow_o = x + RAY_OFFSET * n_shade
            # Visible iff nothing lies strictly before the sampled light
            # point (relative ε keeps the light triangle itself out of its
            # own shadow test). Backend-independent: every backend evaluates
            # the same "∃ accepted t < cutoff" predicate; the kernel's any-hit
            # mode (make_occlusion_fn) short-circuits it on a GPU.
            cutoff = jax.lax.stop_gradient(dist) * (1.0 - 1e-3)
            lit = ~masked_occluded(
                jax.lax.stop_gradient(shadow_o),
                jax.lax.stop_gradient(wi),
                cutoff,
                found & is_diffuse,
            )
            light_mat = scene.mat_id[pick]
            le_y = (
                scene.materials.emissive_color[light_mat]
                * scene.materials.intensity[light_mat][:, None]
            )
            geom = jnp.maximum(cos_x, 0.0) * cos_y / dist2 * total_light_area
            contrib = throughput * (albedo / jnp.pi) * le_y * geom[:, None]
            if mis:
                # Balance heuristic vs the cosine BSDF sampler: the weight
                # pair with the emitter-hit branch above sums to 1 for every
                # (x, y), so the combination stays unbiased.
                pdf_light = dist2 / jnp.maximum(cos_y * total_light_area, 1e-12)
                pdf_bsdf_l = jnp.maximum(cos_x, 0.0) / jnp.pi
                w_light = pdf_light / jnp.maximum(pdf_light + pdf_bsdf_l, 1e-12)
                contrib = contrib * w_light[:, None]
            use = found & is_diffuse & lit & (total_light_area > 0)
            radiance = radiance + jnp.where(use[:, None], contrib, 0.0)

        # Scatter-type select chain, innermost-first over PRESENT types only
        # (absent branches compile away; selected values on present-type
        # lanes are identical to the full chain, and lanes of absent types
        # cannot exist — bit-identical images). Fallbacks below are unused
        # whenever any scatter type exists (scatter = False on such lanes).
        new_d = d
        tp_factor = jnp.ones_like(mat["albedo"])

        if has_glass:
            # GLASS: Schlick-Fresnel-weighted reflect/refract.
            cos_i = jnp.clip(-jnp.sum(d * n, axis=-1), -1.0, 1.0)
            entering = cos_i > 0.0
            n_glass = jnp.where(entering[:, None], n, -n)
            cos_i_abs = jnp.abs(cos_i)
            eta_i = jnp.where(entering, 1.0, mat["ior"])
            eta_t = jnp.where(entering, mat["ior"], 1.0)
            fres = sampling.fresnel_schlick(cos_i_abs, eta_i, eta_t)
            refr, tir = sampling.refract(d, n_glass, (eta_i / eta_t)[:, None])
            reflect_choice = tir | (u[:, 2] < fres)
            new_d = jnp.where(
                reflect_choice[:, None], sampling.reflect(d, n_glass), sampling.normalize_dir(refr)
            )
            tp_factor = jnp.where(
                reflect_choice[:, None], jnp.ones_like(mat["albedo"]), mat["transmittance"]
            )

        if has_mirror:
            # MIRROR: perfect specular reflection scaled by specular color.
            d_mirror = sampling.reflect(d, n_shade)
            new_d = jnp.where(is_mirror[:, None], d_mirror, new_d)
            tp_factor = jnp.where(is_mirror[:, None], mat["specular"], tp_factor)

        if has_diffuse:
            # DIFFUSE: cosine-weighted hemisphere sample (the reference warp,
            # utilities.h:46-55); Lambertian throughput factor = albedo.
            local = sampling.cosine_sample_hemisphere(u[:, 0], u[:, 1])
            d_diffuse = sampling.local_to_world(local, n_shade)
            new_d = jnp.where(is_diffuse[:, None], d_diffuse, new_d)
            tp_factor = jnp.where(is_diffuse[:, None], albedo, tp_factor)

        scatter = found & ~is_emit
        new_throughput = jnp.where(scatter[:, None], throughput * tp_factor, throughput)

        # Offset the new origin off the surface along the travel side.
        if has_glass:
            offset_n = jnp.where(is_glass[:, None] & ~reflect_choice[:, None], -n_glass, n_shade)
        else:
            offset_n = n_shade
        new_o = attrs.point + RAY_OFFSET * offset_n

        alive_next = scatter
        if options.rr_start is not None:
            # Russian roulette on throughput luminance, deterministic per key.
            lum = jnp.max(new_throughput, axis=-1)
            p = jnp.clip(lum, 0.05, 1.0)
            kr = sampler.fold(kb, 7919)
            ur = sampler.uniform(kr, 1)[..., 0]
            do_rr = bounce_idx >= options.rr_start
            survive = ~do_rr | (ur < p)
            new_throughput = jnp.where(
                (do_rr & survive)[:, None], new_throughput / p[:, None], new_throughput
            )
            alive_next = alive_next & survive

        o = jnp.where(scatter[:, None], new_o, o)
        d = jnp.where(scatter[:, None], new_d, d)
        # Next-bounce accounting state: did THIS vertex light-sample (only
        # diffuse vertices do), and with what solid-angle BSDF pdf did it
        # scatter (cosine-weighted ⇒ cosθ/π) — the MIS weight inputs.
        prev_nee_next = scatter & is_diffuse
        cos_scatter = jnp.maximum(jnp.sum(new_d * n_shade, axis=-1), 0.0)
        prev_pdf_next = jnp.where(prev_nee_next, cos_scatter / jnp.pi, 0.0)
        return (o, d, new_throughput, radiance, alive_next, prev_nee_next, prev_pdf_next, keys)

    return bounce


def trace_paths(
    scene: TriangleScene,
    origins: jnp.ndarray,  # (R,3)
    directions: jnp.ndarray,  # (R,3)
    keys: jnp.ndarray,  # (R,) PRNG keys (one per path)
    options: IntegratorOptions,
    intersect_fn=None,
    packed=None,
) -> jnp.ndarray:
    """Trace R paths for ``options.bounces`` bounces; returns radiance (R,3).

    ``intersect_fn(o, d, scene) -> Hit`` defaults to the brute-force oracle;
    the accelerated backends (cluster/BVH/Pallas) plug in here unchanged.
    ``packed``: pre-packed Pallas scene (see make_intersect_fn).
    """
    hybrid = (
        options.compact and options.compact_mode == "hybrid"
        and resolved_intersector(options) == "pallas"
        and options.bounces > 1
    )
    if hybrid:
        # The scan bounces run in mask mode on a once-permuted state.
        options_scan = dataclasses.replace(options, compact_mode="mask")
    else:
        options_scan = options
    bounce = make_bounce_fn(scene, options_scan, intersect_fn=intersect_fn, packed=packed)
    init = init_path_state(origins, directions, keys)
    # Bounce 0 unrolled with compaction statically off: every lane is alive
    # and camera-coherent, so the partition + gathers are pure overhead.
    state = bounce(init, jnp.int32(0), compact_now=False)
    if options.bounces > 1:
        inv = None
        if hybrid:
            # One alive-first permutation of the FULL path state after the
            # bounce-0 death wave; every later bounce mask-culls in place.
            # Per-lane results are position-independent, so the image is
            # bit-identical to the per-bounce permute mode.
            from gpupathtracer_tpu.ops.compaction import partition_alive

            perm, inv = partition_alive(state[4])
            state = jax.tree.map(lambda x: x[perm], state)
        state, _ = jax.lax.scan(
            lambda st, b: (bounce(st, b), None), state, jnp.arange(1, options.bounces)
        )
        if inv is not None:
            return state[3][inv]
    return state[3]  # radiance


def normal_aov(
    scene: TriangleScene,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    options: IntegratorOptions,
    reference_parity: bool = True,
    intersect_fn=None,
) -> jnp.ndarray:
    """The committed reference shading: ``abs(world normal)`` on hit, else 0.

    ``reference_parity=True`` uses the unnormalized inverse-transpose normal
    (kernel.cu:117 + 183, SURVEY.md §2.3.1); False uses the unit geometric
    normal.
    """
    if intersect_fn is None:
        intersect_fn = make_intersect_fn(scene, options)
    hit = intersect_fn(origins, directions, scene)
    idx = jnp.maximum(hit.tri, 0)
    n = scene.gn_ref[idx] if reference_parity else scene.gn[idx]
    color = jnp.abs(n)
    return jnp.where(hit.hit[:, None], color, 0.0)
