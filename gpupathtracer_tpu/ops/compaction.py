"""Ray-stream compaction under static shapes (SURVEY.md §7.3 "compaction
under jit").

XLA needs static shapes, so dead paths can't shrink the array — but they
CAN be made free. ``partition_alive`` computes a stable alive-first
permutation with two cumsums (the segmented-scan compaction the reference
stubbed as its ``d_raysToTrace`` buffer, kernel.cu:300-302). The integrator
permutes rays before intersection and parks dead lanes on a ray that starts
far outside the scene pointing away: whole tiles of dead lanes then fail
the tile×block frustum test and every kernel step for them is skipped —
wavefront compaction expressed as culling.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# A parked ray: far outside any practical scene, pointing further away.
DEAD_ORIGIN = (3.0e7, 3.0e7, 3.0e7)
DEAD_DIR = (0.577350269, 0.577350269, 0.577350269)


def morton_codes(points: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """10-bit-per-axis Morton codes of points (R, 3) inside the box [lo, hi].

    Used to cluster triangles spatially (tight block AABBs for the frustum
    cull) and to sort rays by origin and direction for tile coherence.
    """
    span = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip(((points - lo) / span * 1023.0), 0.0, 1023.0).astype(jnp.uint32)

    def spread(x):  # interleave 10 bits with 2-bit gaps
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def partition_alive(alive: jnp.ndarray):
    """Stable alive-first permutation.

    Returns ``(perm, inv)`` such that ``x[perm]`` lists live lanes first
    (original order preserved within each class) and ``y[inv]`` undoes it.
    O(n) — two cumsums and a scatter; no sort.
    """
    n = alive.shape[0]
    alive_i = alive.astype(jnp.int32)
    n_alive = jnp.sum(alive_i)
    rank_alive = jnp.cumsum(alive_i) - 1  # position among live lanes
    rank_dead = jnp.cumsum(1 - alive_i) - 1  # position among dead lanes
    dest = jnp.where(alive, rank_alive, n_alive + rank_dead)
    # dest is a permutation: dest[i] = new position of lane i  ⇒ inv scatter.
    inv = dest  # y[inv] with y in packed order restores original order ⇒
    # we need perm with packed[j] = orig[perm[j]]: scatter identity by dest.
    perm = jnp.zeros((n,), dest.dtype).at[dest].set(jnp.arange(n, dtype=dest.dtype))
    return perm, inv


def compact_rays(o: jnp.ndarray, d: jnp.ndarray, alive: jnp.ndarray):
    """Permute rays alive-first and park dead lanes on the far ray.

    Returns ``(o_c, d_c, inv)``; gather results with ``res[inv]``.
    """
    perm, inv = partition_alive(alive)
    dead_o = jnp.asarray(DEAD_ORIGIN, o.dtype)
    dead_d = jnp.asarray(DEAD_DIR, d.dtype)
    alive_c = alive[perm][:, None]
    o_c = jnp.where(alive_c, o[perm], dead_o)
    d_c = jnp.where(alive_c, d[perm], dead_d)
    return o_c, d_c, inv


def compact_rays_coherent(
    o: jnp.ndarray, d: jnp.ndarray, alive: jnp.ndarray, key_mode: str = "dir"
):
    """Compaction + coherence in ONE permutation.

    Two sort-key layouts (most-significant field first; both start with the
    dead flag so live lanes pack to the front):

    - ``"dir"``: direction octant, 12-bit direction Morton, 12-bit origin
      Morton — tiles become sign-coherent with tightly bounded direction
      boxes, so the interval frustum CULL fires. Right for long, open
      scenes where rays fly far.
    - ``"origin"``: octant, then 15-bit origin Morton, then 13-bit
      direction Morton — tiles are octant-PURE (sign-coherent direction
      intervals ⇒ finite slab arithmetic) AND share a small origin box.
      The tight origin box makes the per-block conservative entry
      distances MEANINGFUL (with "dir" ordering, scene-spanning origins
      push every enter key to ~0 and front-to-back pruning dies). Right
      for closed/dense scenes with short mean free paths — secondary
      bounces terminate on nearby geometry after visiting only the
      closest few clusters. (Octant must sit ABOVE the origin bits: with
      ~20 rays per 15-bit Morton cell, an origin-major key would pack
      several cells × all 8 octants into one 128-lane tile and the
      direction intervals would straddle zero again.)

    One argsort replaces the two-cumsum partition; dead lanes park on the
    far ray as in :func:`compact_rays`. ``jnp.argsort`` is stable, so
    equal-key lanes keep ray order and the permutation is deterministic.
    Per-lane results are position-independent, so images are bit-identical
    across key modes (tested in tests/test_compaction.py).

    Returns ``(o_c, d_c, inv)``; gather results with ``res[inv]``.
    """
    od = jax.lax.stop_gradient(o)
    dd = jax.lax.stop_gradient(d)
    octant = (
        (dd[:, 0] < 0).astype(jnp.uint32)
        + 2 * (dd[:, 1] < 0).astype(jnp.uint32)
        + 4 * (dd[:, 2] < 0).astype(jnp.uint32)
    )
    ones = jnp.ones((3,), od.dtype)
    dm = morton_codes(dd, -ones, ones)  # 30-bit
    live = jnp.where(alive[:, None], od, jnp.nan)
    lo = jnp.nanmin(live, axis=0)
    hi = jnp.nanmax(live, axis=0)
    lo = jnp.where(jnp.isfinite(lo), lo, 0.0)
    hi = jnp.where(jnp.isfinite(hi), hi, 1.0)
    om = morton_codes(od, lo, hi)
    if key_mode == "origin":
        key = (
            ((~alive).astype(jnp.uint32) << 31)
            | (octant << 28)
            | ((om >> 15) << 13)  # top 15 of 30 Morton bits
            | (dm >> 17)  # top 13
        )
    else:
        key = (
            ((~alive).astype(jnp.uint32) << 31)
            | (octant << 28)
            | ((dm >> 18) << 16)  # top 12 of 30 Morton bits
            | ((om >> 18) << 4)
        )
    perm = jnp.argsort(key)
    inv = jnp.zeros_like(perm).at[perm].set(jnp.arange(perm.shape[0], dtype=perm.dtype))
    dead_o = jnp.asarray(DEAD_ORIGIN, o.dtype)
    dead_d = jnp.asarray(DEAD_DIR, d.dtype)
    alive_c = alive[perm][:, None]
    o_c = jnp.where(alive_c, o[perm], dead_o)
    d_c = jnp.where(alive_c, d[perm], dead_d)
    return o_c, d_c, inv
