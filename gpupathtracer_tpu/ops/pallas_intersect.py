"""Closest-hit and any-hit kernel for Hopper (Pallas, Triton route).

The hot loop of the whole framework — the reference's O(pixels × triangles)
megakernel inner loop (``kernel.cu:133-156``) — as one fused kernel:

- one program per ray tile (``ray_tile`` rays, a power of two); the grid
  runs the tiles in parallel over the SMs;
- each tile walks its own front-to-back schedule of triangle blocks in a
  ``while_loop`` that stops as soon as the next block's conservative entry
  distance reaches the tile's worst running best-t (packet tracing with
  BVH-style t-pruning, minus the tree);
- per visited block, five (ray_tile, K) x (K, tb) products give the
  Plücker decision scalars [s0, s1, s2, D, num] (see ops/plucker.py for
  the math), exact in float32 (``DotAlgorithmPreset.F32_F32_F32``);
- the acceptance tests, the division and the masked min/argmin run in
  registers: only (best_t, best_i) per ray is written out, where the XLA
  formulation round-trips a (rays, 5·tb) decision matrix through memory
  at every block;
- a static ``any_hit`` flag turns the same loop into the NEE shadow query:
  a lane is done at its first accepted t below its cutoff, and a tile stops
  when all of its live lanes are done.

Uniformly one-sided: two-sided primitives are duplicated with flipped
winding at pack time, so the epilogue needs no per-triangle side mask.
The tile×block frustum pre-pass (``tile_block_mask``, ``plan_block_order``)
is plain XLA.

Parity: equal to the Möller–Trumbore oracle (ops/intersect.py) up to fp
rounding at hit boundaries; interpret-mode runs bit-match the packing's jnp
reference (tests/test_plucker.py, tests/test_pallas_kernel.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gpupathtracer_tpu.core import struct
from gpupathtracer_tpu.models.scene import TriangleScene
from gpupathtracer_tpu.ops.compaction import morton_codes
from gpupathtracer_tpu.ops.intersect import BIG, EPSILON, Hit
from gpupathtracer_tpu.ops.plucker import K, NSCALARS, pack_rays

INF = float("inf")

# Rays per program and triangles per block. Both are powers of two (Triton
# tensors must be); the block width also sets the frustum-cull granularity.
DEFAULT_RAY_TILE = 32
TRI_BLOCK = 64
NUM_WARPS = 4
NUM_STAGES = 2

# The decision products are exact float32: edge signs decide hit or miss.
_F32_EXACT = jax.lax.DotAlgorithmPreset.F32_F32_F32

# Tests on a machine without a GPU run the kernel through the Pallas
# interpreter by setting this; production code leaves it False.
INTERPRET = False


def kernel_available() -> bool:
    """True where the kernel's route compiles: a CUDA GPU backend."""
    return jax.default_backend() == "gpu"


def _resolve_interpret(interpret: bool | None) -> bool:
    interpret = INTERPRET if interpret is None else interpret
    if not interpret and not kernel_available():
        raise RuntimeError(
            "the Pallas intersection kernel compiles only for a GPU (Triton "
            f"route); backend is {jax.default_backend()!r}. Use "
            "intersector='plucker' or 'auto' here."
        )
    return interpret


@struct.dataclass
class PackedScene:
    """Duplicated-winding packing + per-block AABBs for the kernel."""

    w: jnp.ndarray  # (nb, NSCALARS, K, tb): per block, [s0|s1|s2|D|num] test matrices
    tri_map: jnp.ndarray  # (nb*tb,) int32 — packed row -> original scene row
    box_lo: jnp.ndarray  # (nb, 3) block AABB
    box_hi: jnp.ndarray  # (nb, 3)
    block_live: jnp.ndarray  # (nb,) int32 — 0 if every row is degenerate
    tri_block: int = struct.field(pytree_node=False, default=TRI_BLOCK)

    @property
    def num_blocks(self) -> int:
        return self.w.shape[0]


# Eager-pack cache: render_frame/render_samples/progressive re-pack the
# SAME concrete scene buffers every frame; the pack is one jitted
# executable but still costs a dispatch + argsort per call. Keyed on the
# identity of the five buffers the pack reads; weakrefs guard id()
# recycling after gc. Small LRU — entries hold the packed device arrays.
_PACK_CACHE: "dict[tuple, tuple]" = {}
_PACK_CACHE_ORDER: list = []
_PACK_CACHE_SIZE = 4


def _pack_cache_fields(scene: TriangleScene):
    return (scene.v0, scene.e1, scene.e2, scene.valid, scene.two_sided)


def _pack_cache_get(scene: TriangleScene, tri_block: int):
    key = tuple(id(x) for x in _pack_cache_fields(scene)) + (tri_block,)
    entry = _PACK_CACHE.get(key)
    if entry is None:
        return key, None
    refs, packed = entry
    if all(r() is f for r, f in zip(refs, _pack_cache_fields(scene))):
        _PACK_CACHE_ORDER.remove(key)
        _PACK_CACHE_ORDER.append(key)
        return key, packed
    _PACK_CACHE.pop(key, None)
    _PACK_CACHE_ORDER.remove(key)
    return key, None


def _pack_cache_put(scene: TriangleScene, key, packed: PackedScene) -> None:
    import weakref

    try:
        refs = tuple(weakref.ref(x) for x in _pack_cache_fields(scene))
    except TypeError:  # non-weakreffable leaves (e.g. plain numpy) — skip
        return
    _PACK_CACHE[key] = (refs, packed)
    _PACK_CACHE_ORDER.append(key)
    while len(_PACK_CACHE_ORDER) > _PACK_CACHE_SIZE:
        old = _PACK_CACHE_ORDER.pop(0)
        _PACK_CACHE.pop(old, None)


@functools.partial(jax.jit, static_argnames=("tri_block",))
def _pack_trimmed(v0, e1, e2, orig_rows, flip_rows, tri_block: int) -> PackedScene:
    """Trimmed-row pack given concrete row selections (jitted: the eager
    pack runs as ONE executable, and under an outer grad/jit trace it
    inlines with traced geometry)."""
    a = jnp.concatenate([v0[orig_rows], v0[flip_rows]])
    b = jnp.concatenate([v0[orig_rows] + e1[orig_rows], v0[flip_rows] + e2[flip_rows]])
    c3 = jnp.concatenate([v0[orig_rows] + e2[orig_rows], v0[flip_rows] + e1[flip_rows]])
    tri_map0 = jnp.concatenate([orig_rows, flip_rows])
    return _pack_rows(a, b, c3, tri_map0, tri_block)


def pack_scene(scene: TriangleScene, tri_block: int | None = None) -> PackedScene:
    """Pack a TriangleScene for the one-sided kernel.

    Two-sided rows (the reference's analytic planes, kernel.cu:8-32, and
    glass meshes) are appended again with swapped e1/e2 (flipped winding), so
    back-face hits become front-face hits of the duplicate and the kernel
    needs no per-triangle side mask. ``tri_map`` sends both copies to the
    original row for attribute resolution. Padding rows are degenerate
    (N = 0 ⇒ rejected by the det test).

    Row TRIMMING needs only the STRUCTURE fields (``valid``, ``two_sided``)
    concrete — geometry may be traced. That covers grad mode: under
    ``jax.grad`` of geometry/materials the liveness masks are closure
    constants, so the pack keeps the trimmed row set (the traced-geometry
    Morton argsort stays in-graph — valid for any values) instead of the
    2×-block full flipped copy. Only when even the structure is traced does
    the static-shape full-copy fallback below apply, with dead blocks
    skipped at run time via ``block_live`` + the cull mask.

    Fully-concrete scenes are additionally CACHED on buffer identity, so
    repeated frames (bench, progressive, live) pack once. ``tri_block``
    defaults to the kernel's TRI_BLOCK.
    """
    import jax.core as jcore

    tri_block = TRI_BLOCK if tri_block is None else tri_block

    struct_concrete = not any(
        isinstance(x, jcore.Tracer) for x in (scene.two_sided, scene.valid)
    )
    if struct_concrete:
        import numpy as _np

        geom_concrete = not any(
            isinstance(x, jcore.Tracer) for x in (scene.v0, scene.e1, scene.e2)
        )
        if geom_concrete:
            key, cached = _pack_cache_get(scene, tri_block)
            if cached is not None:
                return cached
        keep_orig = _np.asarray(scene.valid)
        keep_flip = _np.asarray(scene.two_sided) & keep_orig
        orig_rows = jnp.asarray(_np.where(keep_orig)[0].astype(_np.int32))
        flip_rows = jnp.asarray(_np.where(keep_flip)[0].astype(_np.int32))
        packed = _pack_trimmed(scene.v0, scene.e1, scene.e2, orig_rows, flip_rows, tri_block)
        if geom_concrete:
            _pack_cache_put(scene, key, packed)
        return packed

    a = scene.v0
    b = scene.v0 + scene.e1
    c3 = scene.v0 + scene.e2
    valid = scene.valid
    two = scene.two_sided & valid
    n = scene.num_triangles
    idx = jnp.arange(n, dtype=jnp.int32)

    # Static shapes: always append a full flipped copy, but degenerate the
    # flipped rows of one-sided/invalid triangles (zero them out). The Morton
    # sort below pushes degenerate rows to dedicated blocks, which the
    # liveness mask then skips entirely.
    keep = (two).astype(jnp.float32)[:, None]
    av, bv, cv = a * keep, c3 * keep, b * keep  # flipped winding: swap B and C
    a2 = jnp.concatenate([jnp.where(valid[:, None], a, 0.0), av])
    b2 = jnp.concatenate([jnp.where(valid[:, None], b, 0.0), bv])
    c2 = jnp.concatenate([jnp.where(valid[:, None], c3, 0.0), cv])
    tri_map = jnp.concatenate([idx, idx])
    live_row = jnp.concatenate([valid, two])
    return _pack_rows(a2, b2, c2, tri_map, tri_block, live_row)


def _pack_rows(a2, b2, c2, tri_map, tri_block: int, live_row=None) -> PackedScene:
    m = a2.shape[0]
    if live_row is None:
        live_row = jnp.ones((m,), jnp.bool_)
    pad = (-m) % tri_block
    if pad:
        z = jnp.zeros((pad, 3), jnp.float32)
        a2 = jnp.concatenate([a2, z])
        b2 = jnp.concatenate([b2, z])
        c2 = jnp.concatenate([c2, z])
        tri_map = jnp.concatenate([tri_map, jnp.zeros((pad,), jnp.int32)])
        live_row = jnp.concatenate([live_row, jnp.zeros((pad,), jnp.bool_)])
    m = a2.shape[0]
    nb = m // tri_block

    # Spatial (Morton) sort of live rows; dead rows sort to the tail.
    # Spatially sorted rows give tight per-block AABBs, which is what makes
    # the tile×block frustum culling effective (SURVEY.md §7.1 step 3).
    cent = (a2 + b2 + c2) / 3.0
    live_f = live_row.astype(jnp.float32)[:, None]
    lo = jnp.min(jnp.where(live_f > 0, cent, INF), axis=0)
    hi = jnp.max(jnp.where(live_f > 0, cent, -INF), axis=0)
    lo = jnp.where(jnp.isfinite(lo), lo, 0.0)
    hi = jnp.where(jnp.isfinite(hi), hi, 0.0)
    codes = morton_codes(cent, lo, hi)  # 30-bit uint32
    codes = jnp.where(live_row, codes, jnp.uint32(0xFFFFFFFF))  # dead → tail
    order = jnp.argsort(codes)
    a2, b2, c2 = a2[order], b2[order], c2[order]
    tri_map = tri_map[order]
    live_row = live_row[order]
    # Re-degenerate dead rows (they may carry stale coords after the gather).
    lf = live_row.astype(jnp.float32)[:, None]
    a2, b2, c2 = a2 * lf, b2 * lf, c2 * lf

    e1 = b2 - a2
    e2 = c2 - a2
    n_vec = jnp.cross(e1, e2)
    c_plane = jnp.sum(n_vec * a2, axis=-1)

    def edge_cols(p, q):
        return jnp.concatenate([jnp.cross(p, q), q - p], axis=-1)

    z3 = jnp.zeros((m, 3), jnp.float32)
    z1 = jnp.zeros((m, 1), jnp.float32)

    def pad_k(cols):
        return jnp.pad(cols, ((0, 0), (0, K - cols.shape[1])))

    cols = [
        pad_k(jnp.concatenate([edge_cols(a2, b2), z3, z1], axis=-1)),
        pad_k(jnp.concatenate([edge_cols(b2, c2), z3, z1], axis=-1)),
        pad_k(jnp.concatenate([edge_cols(c2, a2), z3, z1], axis=-1)),
        pad_k(jnp.concatenate([n_vec, z3, z3, z1], axis=-1)),
        pad_k(jnp.concatenate([z3, z3, -n_vec, c_plane[:, None]], axis=-1)),
    ]
    w = jnp.stack(
        [c.reshape(nb, tri_block, K).transpose(0, 2, 1) for c in cols], axis=1
    )  # (nb, NSCALARS, K, tb)

    # Block AABBs over live rows only (dead rows would inflate boxes to the
    # origin); all-dead blocks get empty boxes and block_live = 0.
    verts = jnp.stack([a2, b2, c2], axis=1).reshape(nb, tri_block * 3, 3)
    vlive = jnp.repeat(live_row.reshape(nb, tri_block), 3, axis=1)[..., None]
    box_lo = jnp.min(jnp.where(vlive, verts, INF), axis=1)
    box_hi = jnp.max(jnp.where(vlive, verts, -INF), axis=1)
    block_live = live_row.reshape(nb, tri_block).any(axis=1)
    box_lo = jnp.where(block_live[:, None], box_lo, 0.0)
    box_hi = jnp.where(block_live[:, None], box_hi, -1.0)  # empty box
    return PackedScene(
        w=w,
        tri_map=tri_map,
        box_lo=box_lo,
        box_hi=box_hi,
        block_live=block_live.astype(jnp.int32),
        tri_block=tri_block,
    )


def _interval_div(nlo, nhi, dlo, dhi):
    """Conservative interval [lo,hi]/[dlo,dhi] with 0 ∈ d ⇒ (-inf, inf)."""
    safe = lambda x: jnp.where(x == 0.0, 1e-30, x)
    c1 = nlo / safe(dlo)
    c2 = nlo / safe(dhi)
    c3 = nhi / safe(dlo)
    c4 = nhi / safe(dhi)
    lo = jnp.minimum(jnp.minimum(c1, c2), jnp.minimum(c3, c4))
    hi = jnp.maximum(jnp.maximum(c1, c2), jnp.maximum(c3, c4))
    straddles = (dlo <= 0.0) & (dhi >= 0.0)
    return jnp.where(straddles, -INF, lo), jnp.where(straddles, INF, hi)


def tile_block_mask(o, d, packed: PackedScene, ray_tile: int, alive=None):
    """Conservative tile×block culling data.

    Returns ``(mask, enter)``, both (ray_tiles, tri_blocks):
    - ``mask`` int32: 1 = must test, 0 = provably no hit. Interval-arithmetic
      frustum test — rays of a tile abstracted as origin ∈ [o_min,o_max],
      direction ∈ [d_min,d_max]; a block is skipped when the conservative
      slab intervals of its AABB have empty t ≥ 0 overlap.
    - ``enter`` float32: a LOWER BOUND on the hit distance of any tile ray
      into the block's AABB — the front-to-back ordering / early-exit key.

    ``alive`` (R,) bool: restrict each tile's interval frustum to its LIVE
    lanes — dead lanes neither inflate the boxes nor schedule blocks, so an
    all-dead tile culls everything. This is wavefront compaction with zero
    data movement: no partition, no gathers, no inverse scatter
    (ops/compaction.py is the permute alternative for sort-based coherence).
    """
    rt = o.shape[0] // ray_tile
    ot = o.reshape(rt, ray_tile, 3)
    dt = d.reshape(rt, ray_tile, 3)
    if alive is None:
        o_lo, o_hi = jnp.min(ot, axis=1), jnp.max(ot, axis=1)  # (rt,3)
        d_lo, d_hi = jnp.min(dt, axis=1), jnp.max(dt, axis=1)
        tile_live = None
    else:
        at = alive.reshape(rt, ray_tile, 1)
        o_lo = jnp.min(jnp.where(at, ot, INF), axis=1)
        o_hi = jnp.max(jnp.where(at, ot, -INF), axis=1)
        d_lo = jnp.min(jnp.where(at, dt, INF), axis=1)
        d_hi = jnp.max(jnp.where(at, dt, -INF), axis=1)
        tile_live = at[:, :, 0].any(axis=1)
        # Keep interval arithmetic finite for all-dead tiles (masked below).
        o_lo = jnp.where(tile_live[:, None], o_lo, 0.0)
        o_hi = jnp.where(tile_live[:, None], o_hi, 0.0)
        d_lo = jnp.where(tile_live[:, None], d_lo, 1.0)
        d_hi = jnp.where(tile_live[:, None], d_hi, 1.0)

    # (rt, nb, 3) numerator intervals.
    n_lo = packed.box_lo[None, :, :] - o_hi[:, None, :]
    n_hi = packed.box_hi[None, :, :] - o_lo[:, None, :]
    t_lo, t_hi = _interval_div(n_lo, n_hi, d_lo[:, None, :], d_hi[:, None, :])
    t_lo = jnp.maximum(t_lo, 0.0)
    enter = jnp.max(t_lo, axis=-1)
    exit_ = jnp.min(t_hi, axis=-1)
    # Directions are UNIT vectors, so hit distance t is also euclidean
    # distance — the box-to-box distance between the tile's origin box and
    # the block AABB is a second valid lower bound, and a far TIGHTER one
    # when the tile's direction intervals are wide (incoherent bounces):
    # interval division by d ∈ [~0, 1] collapses t_lo toward 0, while the
    # geometric distance is direction-independent. max of both keeps the
    # front-to-back ordering sharp and lets the in-kernel early exit stop
    # at "every live lane has a hit nearer than any remaining block".
    gap = jnp.maximum(
        jnp.maximum(n_lo, -(n_hi)), 0.0
    )  # per-axis separation: max(blk_lo - o_hi, o_lo - blk_hi, 0)
    dist = jnp.sqrt(jnp.sum(gap * gap, axis=-1))
    enter = jnp.maximum(enter, dist)
    hit_possible = (enter <= exit_) & (packed.block_live[None, :] > 0)
    if tile_live is not None:
        hit_possible &= tile_live[:, None]
    return hit_possible.astype(jnp.int32), enter


def plan_block_order(mask: jnp.ndarray, enter: jnp.ndarray):
    """Per-tile front-to-back block schedule.

    Returns ``(order, enter_sorted)``, both (ray_tiles, nb): ``order[i, j]``
    is the j-th block id tile i should visit (ascending conservative entry
    distance); culled blocks sort to the tail with the sentinel id ``nb``
    (skip) and enter = +inf, so the kernel's while-loop condition
    (``enter_sorted[i, j] < worst best-t``) never reaches them. The loop
    also stops early once ``enter_sorted[i, j]`` reaches the tile's current
    worst best-t — the packet-tracing analogue of BVH front-to-back
    traversal with t-pruning.
    """
    nb = mask.shape[1]
    key = jnp.where(mask > 0, enter, INF)
    order = jnp.argsort(key, axis=1).astype(jnp.int32)
    enter_sorted = jnp.take_along_axis(key, order, axis=1)
    order = jnp.where(jnp.isfinite(enter_sorted), order, nb)
    return order, enter_sorted


def _kernel(order_ref, enter_ref, feats_ref, init_ref, w_ref, best_t_ref, best_i_ref,
            *, tb: int, nb: int, any_hit: bool):
    """One ray tile: front-to-back walk over its block schedule.

    ``init`` seeds each lane's running best-t: BIG for a live closest-hit
    lane, the cutoff max_t for a live any-hit lane, −inf for a dead lane
    (it never updates, and the early-exit bound max(best_t) ignores it).
    Updates are strict ``<``, so earlier blocks win ties (kernel.cu:115).
    In any-hit mode an accepted hit below the cutoff sets best-t to −inf:
    the lane is done, and the tile stops once every lane is."""
    feats = feats_ref[...]

    def cond(state):
        j, _bt, _bi, worst = state
        # Blocks arrive front-to-back; culled entries carry enter = +inf.
        return (j < nb) & (enter_ref[jnp.minimum(j, nb - 1)] < worst)

    def body(state):
        j, best_t, best_i, _worst = state
        blk = order_ref[j]

        def scalar(c):  # (TR, K) x (K, tb), exact f32
            return jnp.dot(
                feats, w_ref[blk, c], precision=_F32_EXACT,
                preferred_element_type=jnp.float32,
            )

        # Folded acceptance: the three edge signs collapse through a max,
        # and t > EPSILON is tested in sign space — dd ≤ −EPS < 0 ⇒
        # (num/dd > EPS ⇔ num < EPS·dd) — so acceptance never waits on
        # the division. The reference's semantics (kernel.cu:48-59 culls,
        # kernel.cu:97 epsilon).
        edge = jnp.maximum(jnp.maximum(scalar(0), scalar(1)), scalar(2))
        dd = scalar(3)
        num = scalar(4)
        ok = (edge <= 0.0) & (dd <= -EPSILON) & (num < EPSILON * dd)
        t = jnp.where(ok, num / dd, BIG)
        blk_min = jnp.min(t, axis=1)
        blk_arg = jnp.argmin(t, axis=1).astype(jnp.int32) + blk * tb
        upd = blk_min < best_t
        best_i = jnp.where(upd, blk_arg, best_i)
        best_t = jnp.where(upd, -INF if any_hit else blk_min, best_t)
        return (j + 1, best_t, best_i, jnp.max(best_t))

    init = init_ref[...]
    state = (jnp.int32(0), init, jnp.full(init.shape, -1, jnp.int32), jnp.max(init))
    _, best_t, best_i, _ = jax.lax.while_loop(cond, body, state)
    best_t_ref[...] = best_t
    best_i_ref[...] = best_i


@functools.partial(jax.jit, static_argnames=("ray_tile", "any_hit", "interpret"))
def _launch(order, enter, feats, init, w, ray_tile: int, any_hit: bool, interpret: bool):
    rp = feats.shape[0]
    nb, _, _, tb = w.shape
    rt = rp // ray_tile
    row = lambda i: (i, 0)
    lanes = lambda i: (i,)
    return pl.pallas_call(
        functools.partial(_kernel, tb=tb, nb=nb, any_hit=any_hit),
        grid=(rt,),
        in_specs=[
            pl.BlockSpec((None, nb), row),  # this tile's block schedule
            pl.BlockSpec((None, nb), row),  # and its sorted entry keys
            pl.BlockSpec((ray_tile, K), row),
            pl.BlockSpec((ray_tile,), lanes),
            pl.BlockSpec((nb, NSCALARS, K, tb), lambda i: (0, 0, 0, 0)),
        ],
        out_specs=[pl.BlockSpec((ray_tile,), lanes), pl.BlockSpec((ray_tile,), lanes)],
        out_shape=[
            jax.ShapeDtypeStruct((rp,), jnp.float32),
            jax.ShapeDtypeStruct((rp,), jnp.int32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        backend="triton",
        name="firefly_any_hit" if any_hit else "firefly_closest_hit",
        interpret=interpret,
    )(order, enter, feats, init, w)


def _run_kernel(o, d, init, packed: PackedScene, ray_tile: int, any_hit: bool, interpret):
    """Shared front end: pad to whole tiles, cull + schedule, launch.

    Lanes with init = −inf are dead: excluded from the tile frustums and
    never updated. Returns (best_t, best_i) for the first R lanes, with
    best_i indexing PACKED rows (−1 = no accepted hit)."""
    interpret = _resolve_interpret(interpret)
    r = o.shape[0]
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    # The whole packed scene is detached: the kernel's discrete search has no
    # VJP (resolve_hits re-derives differentiably); box arrays feeding the
    # cull mask must not leak tangents into pallas_call either.
    packed = jax.lax.stop_gradient(packed)
    init = jax.lax.stop_gradient(init)
    feats = pack_rays(o, d)
    pad = (-r) % ray_tile
    if pad:
        feats = jnp.pad(feats, ((0, pad), (0, 0)))
        o = jnp.pad(o, ((0, pad), (0, 0)))
        d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
        init = jnp.pad(init, (0, pad), constant_values=-INF)
    mask, enter = tile_block_mask(o, d, packed, ray_tile, alive=init > -INF)
    order, enter_sorted = plan_block_order(mask, enter)
    best_t, best_i = _launch(
        order, enter_sorted, feats, init, packed.w, ray_tile, any_hit, interpret
    )
    return best_t[:r], best_i[:r]


def intersect_pallas(
    o: jnp.ndarray,
    d: jnp.ndarray,
    packed: PackedScene,
    ray_tile: int = DEFAULT_RAY_TILE,
    interpret: bool | None = None,
    alive: jnp.ndarray | None = None,
) -> Hit:
    """Closest hit of rays (R,3) against the packed scene. See module doc.

    ``d`` must be UNIT directions (every producer in the framework
    normalizes): the scheduler's front-to-back entry keys use euclidean
    box distance as a lower bound on hit t, which only holds for ‖d‖ = 1.

    Returned ``tri`` indices are original scene rows (tri_map applied), so
    downstream attribute resolution (ops/intersect.py::resolve_hits) is
    backend-agnostic.

    ``alive`` (R,) bool: lanes marked dead are excluded from tile frustums
    and report no hit — mask-based wavefront compaction with zero data
    movement.
    """
    r = o.shape[0]
    live = jnp.ones((r,), jnp.bool_) if alive is None else alive
    init = jnp.where(live, BIG, -INF).astype(jnp.float32)
    best_t, best_i = _run_kernel(o, d, init, packed, ray_tile, False, interpret)
    tri = jnp.where(best_i >= 0, packed.tri_map[jnp.maximum(best_i, 0)], -1)
    return Hit(t=jnp.where(best_i >= 0, best_t, BIG), tri=tri, hit=best_i >= 0)


def intersect_pallas_occluded(
    o: jnp.ndarray,
    d: jnp.ndarray,
    max_t: jnp.ndarray,
    packed: PackedScene,
    ray_tile: int = DEFAULT_RAY_TILE,
    interpret: bool | None = None,
) -> jnp.ndarray:
    """Boolean occlusion query: ∃ accepted hit with t ∈ (EPSILON, max_t)?

    The NEE shadow-ray path: the kernel's any-hit mode. ``max_t = 0`` marks
    lanes that need no testing (dead rays) — they are excluded from the tile
    frustums and report unoccluded, so callers never need to park/permute.
    """
    init = jnp.where(max_t > 0, max_t, -INF).astype(jnp.float32)
    _, best_i = _run_kernel(o, d, init, packed, ray_tile, True, interpret)
    return best_i >= 0


def make_sorted_intersect(intersect_fn, packed: PackedScene, key_mode: str = "dir"):
    """Wrap a closest-hit fn with per-call ray sorting for tile coherence.

    Secondary-bounce rays are direction-incoherent, which defeats the
    interval frustum culling (a tile whose directions straddle 0 on every
    axis has unbounded t intervals). Two key layouts (the standalone twin
    of ops/compaction.py::compact_rays_coherent — see its docstring for
    when each wins):

    - ``"dir"``: (direction octant, direction Morton, origin Morton) —
      sign-coherent tiles with tight direction boxes;
    - ``"origin"``: (octant, origin Morton, direction Morton) — octant-pure
      tiles with small origin boxes, which keeps the euclidean per-block
      entry bounds meaningful for front-to-back early exit (dense scenes).

    Results are scattered back to the original lane order (bit-identical
    hits, order restored).
    """
    lo = packed.box_lo.min(axis=0)
    hi = packed.box_hi.max(axis=0)

    def wrapped(o, d, scene) -> Hit:
        o = jax.lax.stop_gradient(o)
        d = jax.lax.stop_gradient(d)
        octant = (
            (d[:, 0] < 0).astype(jnp.uint32)
            + 2 * (d[:, 1] < 0).astype(jnp.uint32)
            + 4 * (d[:, 2] < 0).astype(jnp.uint32)
        )
        dm = morton_codes(d, jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]))
        om = morton_codes(o, lo, hi)
        if key_mode == "origin":
            key = (octant << 28) | ((om >> 15) << 13) | (dm >> 17)
        else:
            key = (octant << 27) | ((dm >> 18) << 15) | (om >> 15)
        perm = jnp.argsort(key)
        h = intersect_fn(o[perm], d[perm], scene)
        inv = jnp.zeros_like(perm).at[perm].set(jnp.arange(perm.shape[0], dtype=perm.dtype))
        return Hit(t=h.t[inv], tri=h.tri[inv], hit=h.hit[inv])

    return wrapped
