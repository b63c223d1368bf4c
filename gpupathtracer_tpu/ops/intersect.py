"""Closest-hit intersection: vectorized Möller–Trumbore over SoA triangles.

This is the jnp reference implementation of the reference renderer's hot path
(``intersectRays``/``intersectTriangle``/``intersectPlane``/``setIntersection``,
``kernel.cu:8-176``), as dense array code:

- **World-space pretransformed triangles** (see models/scene.py) replace the
  per-ray object-space transform of ``kernel.cu:138``. For the TRS transforms
  the reference supports (positive determinant), hit sets and orderings are
  identical; the world-ray parametric ``t`` with a unit direction *is* the
  reference's world-space euclidean depth metric (``kernel.cu:113-121``).
- **Cull semantics**: the reference rejects back faces twice — via
  ``dot(dir, cross(e1,e2)) > 0`` (kernel.cu:48-51) and via ``det < 1e-6``
  (kernel.cu:57-59). Since ``det = dot(e1, cross(dir, e2)) = -dot(dir, n)``,
  both collapse to requiring ``det >= 1e-6``. Two-sided primitives (the
  reference's analytic planes, kernel.cu:8-32) accept ``|det| >= eps``.
- **Tie-breaking**: strictly-closer wins, first triangle wins ties —
  matching the reference's sequential ``distanceOfPOI < tMax`` loop
  (kernel.cu:115).
- **Block-streamed min-reduction**: a ``lax.scan`` over triangle blocks with
  a running (best_t, best_index) carry bounds peak memory at R×B instead of
  R×N. This brute-force path is the forever-kept test oracle; the accelerated
  paths (accel/bvh.py, ops/plucker.py, the ops/pallas_intersect kernel)
  must match it exactly.

Gradient design: the search itself runs under ``stop_gradient`` (discrete
argmin); ``resolve_hits`` re-derives t/point/normal/uv differentiably from
the gathered winning triangle so dL/d(vertex) flows (SURVEY.md §7 step 6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpupathtracer_tpu.core import struct
from gpupathtracer_tpu.models.materials import MaterialTable
from gpupathtracer_tpu.models.scene import TriangleScene

EPSILON = 1e-6  # the reference's EPSILON (kernel.cu:38)
BIG = 3.0e38  # python float: pallas kernels close over it (no traced constants)


@struct.dataclass
class Hit:
    """Closest-hit record (SoA) — the reference's Intersect (utilities.h:57-66)."""

    t: jnp.ndarray  # (R,) float32 — world-space distance; BIG on miss
    tri: jnp.ndarray  # (R,) int32 — winning triangle row, -1 on miss
    hit: jnp.ndarray  # (R,) bool


def mt_block(o, d, v0, e1, e2, two_sided, t_min: float = EPSILON):
    """Möller–Trumbore for all (ray, triangle) pairs of a block.

    o, d: (R, 3); v0, e1, e2, two_sided: (B, ...). Returns (t, ok): (R, B).
    """
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])  # (R,B,3)
    det = jnp.sum(e1[None, :, :] * pvec, axis=-1)  # (R,B)
    front = det >= EPSILON  # collapsed double backface cull (kernel.cu:48-59)
    ok_det = jnp.where(two_sided[None, :], jnp.abs(det) >= EPSILON, front)
    inv_det = jnp.where(jnp.abs(det) > 0, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = o[:, None, :] - v0[None, :, :]  # (R,B,3)
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * qvec, axis=-1) * inv_det
    ok = (
        ok_det
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)  # kernel.cu:97
    )
    return t, ok


def intersect_brute(
    o: jnp.ndarray,
    d: jnp.ndarray,
    scene: TriangleScene,
    tri_block: int = 512,
    t_min: float = EPSILON,
    ray_chunk: int = 8192,
) -> Hit:
    """Brute-force closest hit of rays (R,3) against every scene triangle.

    The reference algorithm (kernel.cu:133-156) as a block-streamed scan:
    triangle blocks stream through a running (best_t, best_index) carry while
    rays are processed in chunks of ``ray_chunk`` (bounding the transient
    (rays × block) intermediates — the wavefront formulation of the
    reference's O(pixels × tris) hot loop). Discrete outputs only — indices
    are integers and t is stop_gradient'ed; use ``resolve_hits`` for
    differentiable hit attributes.
    """
    n = scene.num_triangles
    assert n % tri_block == 0, f"scene must be padded to {tri_block}"
    nb = n // tri_block
    r = o.shape[0]

    v0 = scene.v0.reshape(nb, tri_block, 3)
    e1 = scene.e1.reshape(nb, tri_block, 3)
    e2 = scene.e2.reshape(nb, tri_block, 3)
    two = scene.two_sided.reshape(nb, tri_block)
    valid = scene.valid.reshape(nb, tri_block)
    starts = jnp.arange(nb, dtype=jnp.int32) * tri_block

    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    sv0, se1, se2 = map(jax.lax.stop_gradient, (v0, e1, e2))

    def chunk_hit(oc, dc):
        def body(carry, blk):
            best_t, best_i = carry
            bv0, be1, be2, btwo, bvalid, start = blk
            t, ok = mt_block(oc, dc, bv0, be1, be2, btwo, t_min)
            t = jnp.where(ok & bvalid[None, :], t, BIG)
            blk_min = jnp.min(t, axis=-1)
            blk_arg = jnp.argmin(t, axis=-1).astype(jnp.int32) + start  # first-wins
            upd = blk_min < best_t  # strict <: earlier block wins ties (kernel.cu:115)
            return (jnp.where(upd, blk_min, best_t), jnp.where(upd, blk_arg, best_i)), None

        init = (
            jnp.full((oc.shape[0],), BIG, jnp.float32),
            jnp.full((oc.shape[0],), -1, jnp.int32),
        )
        (best_t, best_i), _ = jax.lax.scan(body, init, (sv0, se1, se2, two, valid, starts))
        return best_t, best_i

    if r <= ray_chunk:
        best_t, best_i = chunk_hit(o, d)
    else:
        chunk = ray_chunk
        pad = (-r) % chunk
        if pad:
            o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
            d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])
        oc = o.reshape(-1, chunk, 3)
        dc = d.reshape(-1, chunk, 3)
        best_t, best_i = jax.lax.map(lambda args: chunk_hit(*args), (oc, dc))
        best_t = best_t.reshape(-1)[:r]
        best_i = best_i.reshape(-1)[:r]
    return Hit(t=best_t, tri=best_i, hit=best_i >= 0)


@struct.dataclass
class HitAttributes:
    """Differentiable attributes of the winning hit (gathered + re-derived)."""

    t: jnp.ndarray  # (R,)
    point: jnp.ndarray  # (R,3) world intersection point
    gn: jnp.ndarray  # (R,3) unit geometric normal (normalize(cross(e1,e2)), kernel.cu:101)
    sn: jnp.ndarray  # (R,3) interpolated shading normal
    uv: jnp.ndarray  # (R,2) interpolated texture coordinates
    bary: jnp.ndarray  # (R,2) (u, v)
    mat_id: jnp.ndarray  # (R,) int32
    geom_id: jnp.ndarray  # (R,) int32


def resolve_hits(
    o, d, scene: TriangleScene, tri: jnp.ndarray,
    need_sn: bool = True, need_uv: bool = True,
) -> HitAttributes:
    """Recompute hit attributes differentiably for gathered triangles.

    ``tri`` is clamped for gathers; callers must mask with the hit flag.
    Gradient flows to scene vertices/normals and to ray origin/direction.

    ``need_sn`` / ``need_uv`` (static): skip the shading-normal / UV gathers
    and interpolation when the caller doesn't consume them — per-bounce this
    saves ~15 gathered floats per ray plus a normalize (the integrator's
    default path shades with geometric normals, kernel.cu:183 parity, and
    nothing consumes UVs yet). Skipped fields are None.
    """
    idx = jnp.maximum(tri, 0)
    v0 = scene.v0[idx]
    e1 = scene.e1[idx]
    e2 = scene.e2[idx]

    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    safe_det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    inv_det = 1.0 / safe_det
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    # Near-parallel gathered rows (e.g. clamped indices of missed rays) give
    # |t| up to ~1e24; downstream squares would overflow to inf and poison
    # gradients (inf/inf = NaN in VJP residuals). Clamp far inside f32 range.
    t = jnp.clip(t, -1e8, 1e8)

    point = o + t[:, None] * d

    def safe_normalize(x):
        # Clamp inside the sqrt: zero vectors (padding rows, missed rays)
        # must have zero — not NaN — gradients.
        return x / jnp.sqrt(jnp.maximum(jnp.sum(x * x, axis=-1, keepdims=True), 1e-24))

    gn = safe_normalize(jnp.cross(e1, e2))
    w = 1.0 - u - v
    sn = None
    if need_sn:
        sn = safe_normalize(
            w[:, None] * scene.n0[idx] + u[:, None] * scene.n1[idx] + v[:, None] * scene.n2[idx]
        )
    uv = None
    if need_uv:
        uv = w[:, None] * scene.uv0[idx] + u[:, None] * scene.uv1[idx] + v[:, None] * scene.uv2[idx]
    return HitAttributes(
        t=t,
        point=point,
        gn=gn,
        sn=sn,
        uv=uv,
        bary=jnp.stack([u, v], axis=-1),
        mat_id=scene.mat_id[idx],
        geom_id=scene.geom_id[idx],
    )
