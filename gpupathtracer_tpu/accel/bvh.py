"""Flattened stackless BVH: host-side builder + jnp masked traversal.

The reference has no acceleration structure at all — its hot loop is
O(pixels × triangles) Möller–Trumbore (kernel.cu:133-156, SURVEY.md §3.2).
This module provides the classic answer in jit-compatible form:

- **Builder** (numpy, host): median-split over the longest centroid axis,
  depth-first flattening with *escape (miss) links* — the stackless
  threaded layout: on bbox hit continue to node i+1, on miss jump to
  ``miss_link[i]``; leaves own contiguous runs of reordered triangles.
- **Traversal** (jnp): a ``lax.while_loop`` per ray (vmapped) with a
  current-best-t-bounded slab test. No stack, no recursion — compatible
  with jit on every backend.

Role in the framework: the asymptotically-scaling backend (O(log N) per
ray) and the oracle for very large scenes. The GPU hot path is the Pallas
kernel (ops/pallas_intersect.py); under vmap every lane of this per-ray
while-loop waits for the slowest, and its (nodes, links, reordered-tri)
arrays are the basis for a cluster hierarchy the kernel could cull with.

A C++ builder with identical layout lives in native/ (ctypes); this numpy
builder is the always-available fallback and test oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.core import struct
from gpupathtracer_tpu.models.scene import TriangleScene
from gpupathtracer_tpu.ops.intersect import BIG, EPSILON, Hit, mt_block


@struct.dataclass
class Bvh:
    """Flattened threaded BVH over a TriangleScene's rows."""

    box_lo: jnp.ndarray  # (M, 3)
    box_hi: jnp.ndarray  # (M, 3)
    first: jnp.ndarray  # (M,) int32 — leaf: first triangle slot; inner: -1
    count: jnp.ndarray  # (M,) int32 — leaf: triangle count; inner: 0
    miss: jnp.ndarray  # (M,) int32 — escape link (M == done)
    tri_order: jnp.ndarray  # (N,) int32 — slot -> original scene row
    leaf_size: int = struct.field(pytree_node=False, default=8)

    @property
    def num_nodes(self) -> int:
        return self.box_lo.shape[0]


def build_bvh(scene: TriangleScene, leaf_size: int = 8) -> Bvh:
    """Host-side median-split builder (concrete arrays only)."""
    v0 = np.asarray(scene.v0)
    e1 = np.asarray(scene.e1)
    e2 = np.asarray(scene.e2)
    valid = np.asarray(scene.valid)
    rows = np.where(valid)[0].astype(np.int32)
    if rows.size == 0:
        rows = np.zeros((1,), np.int32)

    p0 = v0[rows]
    p1 = v0[rows] + e1[rows]
    p2 = v0[rows] + e2[rows]
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    cent = (lo + hi) * 0.5

    box_lo, box_hi, first, count, miss = [], [], [], [], []
    order: list[np.ndarray] = []

    def emit(idxs: np.ndarray) -> int:
        """Depth-first emit; returns this subtree's root node id."""
        node = len(box_lo)
        box_lo.append(lo[idxs].min(axis=0))
        box_hi.append(hi[idxs].max(axis=0))
        first.append(-1)
        count.append(0)
        miss.append(-1)  # patched after children are emitted
        if idxs.size <= leaf_size:
            first[node] = sum(o.size for o in order)
            count[node] = idxs.size
            order.append(idxs)
            return node
        axis = int(np.argmax(cent[idxs].max(0) - cent[idxs].min(0)))
        med = np.argsort(cent[idxs, axis], kind="stable")
        half = idxs.size // 2
        left, right = idxs[med[:half]], idxs[med[half:]]
        emit(left)
        right_root = emit(right)
        # Left subtree's escape lands on the right subtree's root; handled
        # by the generic patch below (miss of subtree root = next sibling).
        return node

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        emit(np.arange(rows.size))
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(box_lo)
    box_lo_a = np.asarray(box_lo, np.float32)
    box_hi_a = np.asarray(box_hi, np.float32)
    first_a = np.asarray(first, np.int32)
    count_a = np.asarray(count, np.int32)

    # Escape links: in DFS order, a node's subtree occupies [i, end_i); the
    # miss link is end_i. Compute ends with a stack replay.
    miss_a = np.full((m,), m, np.int32)
    stack: list[tuple[int, int]] = []  # (node, subtree_size_remaining) — derive via sizes
    # Subtree sizes: leaf = 1; recompute by walking DFS with counts.
    size = np.ones((m,), np.int32)
    # Children of an inner node are contiguous: left = i+1, right = i+1+size(left).
    # Compute sizes bottom-up via reverse DFS: a node is a leaf iff count>0.
    for i in range(m - 1, -1, -1):
        if count_a[i] > 0:
            size[i] = 1
        else:
            left = i + 1
            right = left + size[left]
            size[i] = 1 + size[left] + size[right]
    for i in range(m):
        miss_a[i] = i + size[i]

    tri_order = rows[np.concatenate(order)] if order else rows[:0]
    # Pad slot array to a multiple of leaf_size for static-shape leaf tests.
    pad = (-tri_order.size) % max(leaf_size, 1)
    if pad:
        tri_order = np.concatenate([tri_order, np.full((pad,), -1, np.int32)])

    return Bvh(
        box_lo=jnp.asarray(box_lo_a),
        box_hi=jnp.asarray(box_hi_a),
        first=jnp.asarray(first_a),
        count=jnp.asarray(count_a),
        miss=jnp.asarray(miss_a),
        tri_order=jnp.asarray(tri_order.astype(np.int32)),
        leaf_size=leaf_size,
    )


def intersect_bvh(
    o: jnp.ndarray, d: jnp.ndarray, scene: TriangleScene, bvh: Bvh, t_min: float = EPSILON
) -> Hit:
    """Closest hit via stackless traversal; semantics == the brute oracle."""
    leaf = bvh.leaf_size
    n_nodes = bvh.num_nodes

    sv0 = jax.lax.stop_gradient(scene.v0)
    se1 = jax.lax.stop_gradient(scene.e1)
    se2 = jax.lax.stop_gradient(scene.e2)
    two = scene.two_sided
    valid = scene.valid

    def one_ray(oo, dd):
        inv_d = 1.0 / jnp.where(jnp.abs(dd) < 1e-20, 1e-20, dd)

        def slab_hit(node, best_t):
            t0 = (bvh.box_lo[node] - oo) * inv_d
            t1 = (bvh.box_hi[node] - oo) * inv_d
            tn = jnp.minimum(t0, t1)
            tf = jnp.maximum(t0, t1)
            enter = jnp.max(tn)
            exit_ = jnp.min(tf)
            return (enter <= exit_) & (exit_ > 0.0) & (enter < best_t)

        def body(state):
            node, best_t, best_i = state
            hit_box = slab_hit(node, best_t)
            is_leaf = bvh.count[node] > 0

            def leaf_test(args):
                best_t, best_i = args
                start = bvh.first[node]
                slots = start + jnp.arange(leaf, dtype=jnp.int32)
                in_leaf = jnp.arange(leaf) < bvh.count[node]
                tri = bvh.tri_order[jnp.clip(slots, 0, bvh.tri_order.shape[0] - 1)]
                tri = jnp.where(in_leaf, tri, 0)
                ok_row = in_leaf & (tri >= 0) & valid[tri]
                t, ok = mt_block(oo[None, :], dd[None, :], sv0[tri], se1[tri], se2[tri], two[tri], t_min)
                t = jnp.where(ok[0] & ok_row, t[0], BIG)
                j = jnp.argmin(t)
                tmin = t[j]
                upd = tmin < best_t
                return jnp.where(upd, tmin, best_t), jnp.where(upd, tri[j], best_i)

            best_t, best_i = jax.lax.cond(
                hit_box & is_leaf, leaf_test, lambda a: a, (best_t, best_i)
            )
            nxt = jnp.where(hit_box & ~is_leaf, node + 1, bvh.miss[node])
            return nxt, best_t, best_i

        def cond(state):
            node, _, _ = state
            return node < n_nodes

        _, best_t, best_i = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.float32(BIG), jnp.int32(-1))
        )
        return best_t, best_i

    best_t, best_i = jax.vmap(one_ray)(jax.lax.stop_gradient(o), jax.lax.stop_gradient(d))
    return Hit(t=best_t, tri=best_i, hit=best_i >= 0)
