"""Sharded rendering: shard_map over the ('data', 'scene') mesh.

Parallel decomposition (SURVEY.md §2.4):

- **'data' (DP/SP)**: row-major pixel slices per device. Sample keys depend
  only on logical pixel/sample ids (ops/sampling.py::pixel_sample_key), so
  the sharded render is *bit-identical* to the single-device render — the
  determinism property the distributed tests assert (SURVEY.md §4.5).
- **'scene' (TP analogue)**: triangle rows are sharded; each device finds
  the closest hit in its shard, then the winner is resolved with an
  all-gather + first-wins argmin over the 'scene' axis — numerically exactly
  the reference's sequential strictly-nearer loop (kernel.cu:110-125),
  because shard s holds rows [s·K, (s+1)·K) in scene order and argmin
  tie-breaks toward lower shard ids.
- Shading reads the replicated scene (materials + attribute arrays); only
  the intersection sweep is sharded. Ring rotation of scene blocks (for
  scenes exceeding per-chip HBM) is the planned extension of this layout.

Everything is jit + shard_map; backward (jax.grad through the shard_map)
gives data-parallel gradients with XLA-inserted psums — used by the
distributed training step in __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from gpupathtracer_tpu.models.camera import Camera
from gpupathtracer_tpu.models.scene import TriangleScene
from gpupathtracer_tpu.ops.intersect import BIG, Hit
from gpupathtracer_tpu.render.integrator import make_intersect_fn
from gpupathtracer_tpu.render.renderer import (
    RenderSettings,
    _integrator_options,
    accumulate_radiance,
)

_ROW_FIELDS = (
    "v0", "e1", "e2", "gn", "gn_ref", "n0", "n1", "n2",
    "uv0", "uv1", "uv2", "geom_id", "mat_id", "two_sided", "valid",
)


def shard_scene_rows(scene: TriangleScene, n_scene: int) -> dict:
    """Triangle row arrays reshaped (N, ...) → (n_scene, N/n_scene, ...).

    Returned as a dict so shard_map can shard every leaf's leading axis over
    'scene' while the full scene (materials included) rides along replicated.
    """
    n = scene.num_triangles
    assert n % n_scene == 0, f"triangle count {n} not divisible by scene axis {n_scene}"
    return {
        f: getattr(scene, f).reshape(n_scene, n // n_scene, *getattr(scene, f).shape[1:])
        for f in _ROW_FIELDS
    }


def make_ring_intersect(
    local_scene: TriangleScene, rows_per_shard: int, n_scene: int, options
):
    """Closest hit across 'scene' via ring rotation (SURVEY.md §2.4 SP row).

    The ring-attention analogue: rays stay RESIDENT on their device; the
    scene row-shards rotate around the 'scene' ring with ``ppermute``, and a
    running min-(t, global row) folds after each hop. Per step each device
    moves one scene shard to its ring neighbour instead of all-gathering per-ray hit
    records — for R rays and S shards the wire cost is S·|shard| (scene-
    sized, ray-independent), vs the all-gather resolve's S·R hit records;
    the fold is numerically exact, so results are bit-identical to the
    all-gather strategy and to single-device rendering.

    Tie semantics match the reference's sequential strictly-nearer loop
    (kernel.cu:110-125): strict t wins; equal t resolves to the lowest
    global scene row, independent of visit order.
    """
    me = jax.lax.axis_index("scene").astype(jnp.int32)
    rows0 = {f: getattr(local_scene, f) for f in _ROW_FIELDS}
    fwd_perm = [(i, (i + 1) % n_scene) for i in range(n_scene)]

    def intersect(o, d, _scene) -> Hit:
        r = o.shape[0]

        def step(carry, k):
            rows, best_t, best_i = carry
            holder = jnp.mod(me - k, n_scene)  # whose rows we currently hold
            scene_k = local_scene.replace(**rows)
            h = make_intersect_fn(scene_k, options)(o, d, scene_k)
            tri_g = jnp.where(h.tri >= 0, h.tri + holder * rows_per_shard, -1)
            take = h.hit & (
                (h.t < best_t)
                | ((h.t == best_t) & ((best_i < 0) | (tri_g < best_i)))
            )
            best_t = jnp.where(take, h.t, best_t)
            best_i = jnp.where(take, tri_g, best_i)
            rows = jax.tree.map(
                lambda x: jax.lax.ppermute(x, "scene", fwd_perm), rows
            )
            return (rows, best_t, best_i), None

        init = (
            rows0,
            jnp.full((r,), BIG, jnp.float32),
            jnp.full((r,), -1, jnp.int32),
        )
        (_, best_t, best_i), _ = jax.lax.scan(
            step, init, jnp.arange(n_scene, dtype=jnp.int32)
        )
        return Hit(t=best_t, tri=best_i, hit=best_i >= 0)

    return intersect


def make_ulysses_intersect(
    local_scene: TriangleScene, rows_per_shard: int, n_scene: int, options
):
    """Closest hit via Ulysses-style all-to-all resharding (SURVEY.md §2.4
    SP row, §5 "Ulysses analogue").

    The phase-reshard formulation: between the pixel-sharded gen/shade
    phases and the scene-block-sharded intersect phase, rays change layout
    instead of the scene moving or hit records being replicated:

    1. gen/shade run with pixels sharded over BOTH mesh axes — each device
       owns r_local = R/(D·S) rays (no redundant shading work, unlike the
       all-gather strategy where every 'scene' peer shades the same rays);
    2. ``all_gather`` over 'scene' re-lays rays out block-sharded: every
       device gets its group's S·r_local rays against its N/S scene rows;
    3. the partial hit records transpose BACK to pixel layout with ONE
       ``lax.all_to_all`` — device s keeps its ray chunk, receiving each
       peer's candidate (t, row) for exactly those rays;
    4. a local first-wins argmin over the shard axis resolves the winner
       (shard order == scene row order, so ties break identically to the
       reference's sequential loop, kernel.cu:110-125).

    Wire cost per device per bounce: S·r_local ray records out (gather) +
    S·r_local hit records (all_to_all) — ray-sized and independent of scene
    size, vs the ring strategy's S·|shard| scene-sized traffic and the
    all-gather strategy's S·R hit records. See ARCHITECTURE.md for the
    crossover discussion.
    """
    local_fn = make_intersect_fn(local_scene, options)
    offset = jax.lax.axis_index("scene").astype(jnp.int32) * rows_per_shard

    def intersect(o, d, _scene) -> Hit:
        r_local = o.shape[0]
        # pixel layout -> scene-block layout: gather the group's rays.
        o_all = jax.lax.all_gather(o, "scene", tiled=True)  # (S*r_local, 3)
        d_all = jax.lax.all_gather(d, "scene", tiled=True)
        h = local_fn(o_all, d_all, local_scene)
        tri_g = jnp.where(h.tri >= 0, h.tri + offset, -1)
        # scene-block layout -> pixel layout: transpose partial hits so each
        # device holds all S candidates for its own r_local rays.
        t_all = jax.lax.all_to_all(
            h.t.reshape(n_scene, r_local), "scene", split_axis=0, concat_axis=0
        )  # (S, r_local): row p = peer p's candidate for my chunk
        i_all = jax.lax.all_to_all(
            tri_g.reshape(n_scene, r_local), "scene", split_axis=0, concat_axis=0
        )
        s = jnp.argmin(t_all, axis=0)  # first-wins == scene-order ties
        rr = jnp.arange(r_local)
        best_t = t_all[s, rr]
        best_i = i_all[s, rr]
        return Hit(t=best_t, tri=best_i, hit=best_i >= 0)

    return intersect


def make_scene_sharded_intersect(local_scene: TriangleScene, rows_per_shard: int, options):
    """Closest hit across the 'scene' axis: local sweep + all-gather argmin."""
    local_fn = make_intersect_fn(local_scene, options)

    def intersect(o, d, _scene) -> Hit:
        h = local_fn(o, d, local_scene)
        offset = jax.lax.axis_index("scene").astype(jnp.int32) * rows_per_shard
        tri_global = jnp.where(h.tri >= 0, h.tri + offset, -1)
        t_all = jax.lax.all_gather(h.t, "scene")  # (S, r)
        i_all = jax.lax.all_gather(tri_global, "scene")
        # First-wins argmin over shards == scene-order tie-breaking.
        s = jnp.argmin(t_all, axis=0)
        r = jnp.arange(t_all.shape[1])
        best_t = t_all[s, r]
        best_i = i_all[s, r]
        return Hit(t=best_t, tri=best_i, hit=best_i >= 0)

    return intersect


def render_frame_distributed(
    scene: TriangleScene,
    camera: Camera,
    settings: RenderSettings,
    mesh: Mesh,
    seed: jnp.ndarray | None = None,
    scene_strategy: str = "allgather",
) -> jnp.ndarray:
    """Distributed render: returns the (H, W, 3) mean-radiance frame.

    Pixels shard over 'data'; the intersection sweep shards over 'scene'.
    ``scene_strategy`` picks the hit-resolution collective:

    - "allgather": every 'scene' peer traces all of its data-shard's rays
      against its rows, then per-ray hit records all-gather + first-wins
      argmin;
    - "ring": ``ppermute`` scene-shard rotation with rays resident —
      scene-sized wire cost, the ring-attention analogue;
    - "ulysses": pixels shard over BOTH axes (gen/shade r/(D·S) rays per
      device); rays reshard pixel-layout ↔ scene-block-layout around the
      intersect phase with all_gather + ``lax.all_to_all`` — ray-sized wire
      cost AND no redundant shading (the Ulysses attention analogue).

    Bit-identical to render_frame for any mesh shape and every strategy
    (layout-invariant keys, per-pixel accumulation, exact hit resolution).
    """
    h, w = settings.height, settings.width
    r = h * w
    n_data = mesh.shape["data"]
    n_scene = mesh.shape["scene"]
    ulysses = scene_strategy == "ulysses" and n_scene > 1
    pix_axes = ("data", "scene") if ulysses else "data"
    n_pix_shards = n_data * n_scene if ulysses else n_data
    assert r % n_pix_shards == 0, f"pixels {r} not divisible by {n_pix_shards} pixel shards"

    pixel_idx = jnp.arange(r, dtype=jnp.uint32)
    base_key = jax.random.PRNGKey(settings.seed if seed is None else seed)
    rows = shard_scene_rows(scene, n_scene)
    rows_per_shard = scene.num_triangles // n_scene
    # Same EP-analogue narrowing as render_frame (bit-identical; shared
    # helper respects caller-pinned non-default sets).
    from gpupathtracer_tpu.render.renderer import narrow_settings

    settings = narrow_settings(scene, settings)
    opts = _integrator_options(settings)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(pix_axes), P(None), P("scene"), P(None)),
        out_specs=P(pix_axes),
        check_vma=False,
    )
    def run(pix, scene_rep, tri_shard, key):
        local_scene = scene_rep.replace(
            **{f: tri_shard[f][0] for f in _ROW_FIELDS}
        )
        if n_scene == 1:
            intersect_fn = make_intersect_fn(local_scene, opts)
        elif ulysses:
            intersect_fn = make_ulysses_intersect(local_scene, rows_per_shard, n_scene, opts)
        elif scene_strategy == "ring":
            intersect_fn = make_ring_intersect(local_scene, rows_per_shard, n_scene, opts)
        else:
            intersect_fn = make_scene_sharded_intersect(local_scene, rows_per_shard, opts)
        return accumulate_radiance(scene_rep, camera, pix, settings, key, intersect_fn)

    film_sum = run(pixel_idx, scene, rows, base_key)
    return (film_sum / settings.spp).reshape(h, w, 3)
