"""Plücker-coordinate ray-triangle intersection as matrix multiplies.

A matrix-product reformulation of the reference's per-thread scalar
Möller–Trumbore loop (``kernel.cu:35-108,133-156``): all the FLOPs become
one dense product per triangle block by exploiting the *bilinearity* of the
Plücker side tests.

For a ray (o, d) with Plücker moment m = o × d, and a triangle ABC with
directed edges PQ ∈ {AB, BC, CA}:

    side(ray, PQ) = d · (P × Q) + (o × d) · (Q − P)

is bilinear in the ray 6-vector [d, m] and the edge 6-vector [P×Q, Q−P].
The ray is inside the triangle iff all three sides share one sign (the sign
is the facing: side sum = −d·N). With the plane quantities N = e1 × e2 and
c = N · A:

    det = −d·N        (the Möller–Trumbore determinant)
    t   = (c − N·o) / (N·d)

So per (ray, triangle) pair, all five decision scalars [s0, s1, s2, N·d,
c − N·o] come from ONE matmul: rays packed as (R, 16) feature rows
[d, m, o, 1, pad], triangles packed as a (16, 5·B) column matrix: 16·5 = 80
MACs/pair, then a cheap elementwise epilogue (sign tests, one divide,
masked min).

Semantics match ops/intersect.py (the MT oracle) exactly up to fp rounding:
- one-sided accept: det ≥ 1e-6 (the reference's collapsed double cull);
- two-sided accept: |det| ≥ 1e-6;
- inclusive side tests (s_i·det ≥ 0 ⇔ MT's inclusive u/v bounds);
- t > 1e-6 (kernel.cu:97); strictly-nearer wins, first index wins ties.

This module: feature packing + the pure-jnp (XLA) implementation. The
Pallas kernel (ops/pallas_intersect.py) uses the same features and math.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpupathtracer_tpu.core import struct
from gpupathtracer_tpu.models.scene import TriangleScene
from gpupathtracer_tpu.ops.intersect import BIG, EPSILON, Hit

K = 16  # ray/triangle feature depth (10 used, padded for tile alignment)
NSCALARS = 5  # s0, s1, s2, D = N·d, num = c − N·o


@struct.dataclass
class PackedTriangles:
    """Per-block triangle test matrices + masks for the XLA scan."""

    w: jnp.ndarray  # (nb, K, NSCALARS*tb) — block column layout [s0|s1|s2|D|num]
    valid: jnp.ndarray  # (nb, tb) float32 1/0
    two_sided: jnp.ndarray  # (nb, tb) float32 1/0
    tri_block: int = struct.field(pytree_node=False, default=512)

    @property
    def num_blocks(self) -> int:
        return self.w.shape[0]


def pack_triangles(scene: TriangleScene, tri_block: int = 512) -> PackedTriangles:
    """Build the (K, 5B) triangle test matrix from SoA scene arrays.

    Traceable; gradients flow to vertices through w (the Pallas forward is
    wrapped in stop_gradient by the integrator, but resolve_hits re-derives
    differentiably — same split as the brute-force path).
    """
    n = scene.num_triangles
    assert n % tri_block == 0
    a = scene.v0
    b = scene.v0 + scene.e1
    c3 = scene.v0 + scene.e2

    def edge_cols(p, q):
        # side = d·(P×Q) + m·(Q−P): rows 0-2 weight d, rows 3-5 weight m.
        return jnp.concatenate([jnp.cross(p, q), q - p], axis=-1)  # (n, 6)

    n_vec = jnp.cross(scene.e1, scene.e2)  # (n,3)
    c_plane = jnp.sum(n_vec * a, axis=-1)  # (n,)

    z3 = jnp.zeros((n, 3), jnp.float32)
    z1 = jnp.zeros((n, 1), jnp.float32)

    def pad_k(cols):  # (n, used) -> (n, K)
        return jnp.pad(cols, ((0, 0), (0, K - cols.shape[1])))

    col_s0 = pad_k(jnp.concatenate([edge_cols(a, b), z3, z1], axis=-1))
    col_s1 = pad_k(jnp.concatenate([edge_cols(b, c3), z3, z1], axis=-1))
    col_s2 = pad_k(jnp.concatenate([edge_cols(c3, a), z3, z1], axis=-1))
    col_d = pad_k(jnp.concatenate([n_vec, z3, z3, z1], axis=-1))
    col_num = pad_k(jnp.concatenate([z3, z3, -n_vec, c_plane[:, None]], axis=-1))

    nb = n // tri_block
    # (nb, tb, K) per scalar -> (nb, K, 5*tb) with [s0|s1|s2|D|num] column order.
    def blk(cols):
        return cols.reshape(nb, tri_block, K).transpose(0, 2, 1)  # (nb, K, tb)

    w = jnp.concatenate([blk(col_s0), blk(col_s1), blk(col_s2), blk(col_d), blk(col_num)], axis=-1)
    return PackedTriangles(
        w=w,
        valid=scene.valid.reshape(nb, tri_block).astype(jnp.float32),
        two_sided=scene.two_sided.reshape(nb, tri_block).astype(jnp.float32),
        tri_block=tri_block,
    )


def pack_rays(o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Rays (R,3),(R,3) → feature rows (R, K) = [d, o×d, o, 1, 0...]."""
    r = o.shape[0]
    ones = jnp.ones((r, 1), jnp.float32)
    feats = jnp.concatenate([d, jnp.cross(o, d), o, ones], axis=-1)
    return jnp.pad(feats, ((0, 0), (0, K - feats.shape[1])))


def decide(s0, s1, s2, dd, num, valid, two_sided, t_min: float = EPSILON):
    """Acceptance epilogue of the XLA scan.

    All inputs (R, B) except valid/two_sided (B,)-broadcastable. Returns
    (t, ok) with t = BIG where not ok.
    """
    det = -dd
    front = det >= EPSILON
    back = det <= -EPSILON
    ok_det = front | ((two_sided > 0) & back)
    # Inclusive inside test: every side shares the sign of d·N (or is zero);
    # for a front-face hit (det = −d·N > 0) the three sides are all ≤ 0.
    ok_side = (s0 * dd >= 0) & (s1 * dd >= 0) & (s2 * dd >= 0)
    safe_dd = jnp.where(dd == 0, 1.0, dd)
    t = num / safe_dd
    ok = ok_det & ok_side & (t > t_min) & (valid > 0) & (dd != 0)
    return jnp.where(ok, t, BIG), ok


def intersect_plucker_jnp(
    o: jnp.ndarray, d: jnp.ndarray, packed: PackedTriangles, ray_chunk: int = 4096
) -> Hit:
    """Closest hit by a scan over triangle blocks (same math as the Pallas
    kernel, XLA-scheduled, no culling)."""
    tb = packed.tri_block
    r = o.shape[0]
    feats = pack_rays(jax.lax.stop_gradient(o), jax.lax.stop_gradient(d))
    w = jax.lax.stop_gradient(packed.w)
    starts = jnp.arange(packed.num_blocks, dtype=jnp.int32) * tb

    def chunk_hit(fc):
        def body(carry, blk):
            best_t, best_i = carry
            wj, validj, twoj, start = blk
            # Exact f32: the edge signs decide hit or miss (a GPU would
            # otherwise run this product in TF32).
            s = jnp.dot(
                fc, wj, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )  # (C, 5*tb)
            t, _ = decide(
                s[:, 0 * tb : 1 * tb],
                s[:, 1 * tb : 2 * tb],
                s[:, 2 * tb : 3 * tb],
                s[:, 3 * tb : 4 * tb],
                s[:, 4 * tb : 5 * tb],
                validj[None, :],
                twoj[None, :],
            )
            blk_min = jnp.min(t, axis=-1)
            blk_arg = jnp.argmin(t, axis=-1).astype(jnp.int32) + start
            upd = blk_min < best_t
            return (jnp.where(upd, blk_min, best_t), jnp.where(upd, blk_arg, best_i)), None

        init = (
            jnp.full((fc.shape[0],), BIG, jnp.float32),
            jnp.full((fc.shape[0],), -1, jnp.int32),
        )
        (bt, bi), _ = jax.lax.scan(body, init, (w, packed.valid, packed.two_sided, starts))
        return bt, bi

    if r <= ray_chunk:
        best_t, best_i = chunk_hit(feats)
    else:
        pad = (-r) % ray_chunk
        if pad:
            feats = jnp.pad(feats, ((0, pad), (0, 0)))
        fc = feats.reshape(-1, ray_chunk, K)
        best_t, best_i = jax.lax.map(chunk_hit, fc)
        best_t = best_t.reshape(-1)[:r]
        best_i = best_i.reshape(-1)[:r]
    best_t = jnp.where(best_i >= 0, best_t, BIG)
    return Hit(t=best_t, tri=best_i, hit=best_i >= 0)
