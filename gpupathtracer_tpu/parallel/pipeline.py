"""Pipeline-parallel staged wavefront (SURVEY.md §2.4 PP row).

Bounce stages pipelined across a ``('pipe',)`` mesh axis: stage k executes
bounce k of the wavefront loop; ray MICROBATCHES flow through the stages,
so after the fill phase every stage works on a different microbatch each
step — the path-tracing analogue of GPipe-style microbatched pipelining,
with the wavefront state tuple (render/integrator.py::make_bounce_fn) as
the inter-stage activation.

Schedule (S stages, M microbatches, T = M + S − 1 steps):

    step t: stage 0 loads microbatch t (t < M) and applies bounce 0;
            stage k applies bounce k to microbatch t−k;
            stage S−1 writes microbatch t−S+1's finished radiance;
            states rotate k → k+1 around the device ring (``ppermute``).

Stages holding no microbatch carry an inert dead state (no lane alive —
every bounce application is a no-op by the integrator's masked-liveness
discipline), so no step needs divergent control flow.

Bit-exactness: per-lane results depend only on the lane's ray and key
(counter-based RNG keyed by (pixel, sample, bounce)), so the microbatched,
staged execution is bit-identical to the sequential ``lax.scan`` — asserted
against ``render_frame`` in tests/test_pipeline.py.

STATUS — structural demo, not a performance feature (an honest scope
statement per VERDICT r3 item 8): this validates the §2.4 PP schedule and
its exactness, but it requires ``bounces == n_stages``, builds its bounce
fn without the eager pre-pack / per-bounce compaction fast paths, and has
never been profiled on hardware. Path tracing has no weight-residency
motive for PP (the scene is replicated or scene-sharded; activations ARE
the work), so pure DP — equal rays per chip, zero inter-stage traffic — is
expected to dominate at every scale this framework targets; PP would only
matter if per-stage state (e.g. per-bounce megatexture/LOD residency)
exceeded chip memory. Prefer ``parallel/render.py`` for real deployments.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.6 canonical location
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from gpupathtracer_tpu.models.camera import Camera, generate_rays_for_pixels
from gpupathtracer_tpu.models.scene import TriangleScene
from gpupathtracer_tpu.ops import sampling
from gpupathtracer_tpu.render.integrator import (
    dead_path_state,
    init_path_state,
    make_bounce_fn,
)
from gpupathtracer_tpu.render.renderer import RenderSettings, _integrator_options


def make_pipe_mesh(n_pipe: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()[:n_pipe]
    import numpy as np

    return Mesh(np.asarray(devices).reshape(n_pipe), ("pipe",))


def trace_paths_pipelined(
    scene: TriangleScene,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    keys: jnp.ndarray,
    options,
    mesh: Mesh,
    microbatches: int = 4,
) -> jnp.ndarray:
    """Radiance (R, 3) with bounce k executed on pipe stage k.

    Requires ``options.bounces == mesh.shape['pipe']`` (one bounce per
    stage) and R divisible by ``microbatches``.
    """
    n_stages = mesh.shape["pipe"]
    assert options.bounces == n_stages, "one bounce per pipe stage"
    r = origins.shape[0]
    assert r % microbatches == 0, f"rays {r} not divisible by {microbatches} microbatches"
    rmb = r // microbatches
    m = microbatches
    total_steps = m + n_stages - 1

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None), P(None), P(None), P(None)),
        out_specs=P("pipe"),
        check_vma=False,
    )
    def run(scene_rep, o_all, d_all, keys_all):
        k = jax.lax.axis_index("pipe").astype(jnp.int32)
        bounce = make_bounce_fn(scene_rep, options)
        o_mb = o_all.reshape(m, rmb, 3)
        d_mb = d_all.reshape(m, rmb, 3)
        keys_mb = keys_all.reshape(m, rmb, *keys_all.shape[1:])
        fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]

        def step(carry, t):
            state, out = carry
            mb = t - k  # microbatch resident at this stage this step
            # Stage 0 ingests microbatch t (replacing whatever it holds).
            load = (k == 0) & (t < m)
            t_c = jnp.clip(t, 0, m - 1)
            fresh = init_path_state(o_mb[t_c], d_mb[t_c], keys_mb[t_c])
            state = jax.tree.map(
                lambda f, s: jnp.where(
                    jnp.reshape(load, (1,) * f.ndim).astype(bool), f, s
                ),
                fresh,
                state,
            )
            state = bounce(state, k)  # bounce index = stage index
            # Last stage retires microbatch mb after its final bounce.
            retire = (k == n_stages - 1) & (mb >= 0) & (mb < m)
            mb_c = jnp.clip(mb, 0, m - 1)
            radiance = state[3]
            out = jnp.where(
                retire,
                jax.lax.dynamic_update_index_in_dim(out, radiance, mb_c, 0),
                out,
            )
            # Rotate states forward; stage 0's incoming (from the last
            # stage) is retired work — kill it so it can never re-bounce.
            state = jax.tree.map(lambda x: jax.lax.ppermute(x, "pipe", fwd), state)
            dead = dead_path_state(rmb, state[7])
            state = jax.tree.map(
                lambda dd, s: jnp.where(
                    jnp.reshape(k == 0, (1,) * dd.ndim).astype(bool), dd, s
                ),
                dead,
                state,
            )
            return (state, out), None

        init = (
            dead_path_state(rmb, keys_mb[0]),
            jnp.zeros((m, rmb, 3), jnp.float32),
        )
        (_, out), _ = jax.lax.scan(step, init, jnp.arange(total_steps, dtype=jnp.int32))
        return out[None]  # (1, M, rmb, 3); stacked (S, ...) outside

    stacked = run(scene, origins, directions, keys)
    return stacked[-1].reshape(r, 3)  # the last stage's buffer holds the results


def render_frame_pipelined(
    scene: TriangleScene,
    camera: Camera,
    settings: RenderSettings,
    mesh: Mesh,
    seed=None,
    microbatches: int = 4,
) -> jnp.ndarray:
    """Full frame through the staged-wavefront pipeline; bit-identical to
    render_frame (same keys, same per-lane bounce sequence)."""
    h, w = settings.height, settings.width
    r = h * w
    opts = _integrator_options(settings)
    pixel_idx = jnp.arange(r, dtype=jnp.uint32)
    base_key = jax.random.PRNGKey(settings.seed if seed is None else seed)

    sampler = sampling.make_sampler(settings.rng)

    def sample_step(film_sum, s):
        keys = sampler.path_keys(base_key, pixel_idx, s)
        if settings.jitter and settings.spp > 1:
            jitter_uv = sampler.uniform(sampler.fold(keys, 0xA11A), 2)
        else:
            jitter_uv = None
        o, d = generate_rays_for_pixels(camera, pixel_idx, jitter_uv)
        radiance = trace_paths_pipelined(
            scene, o, d, keys, opts, mesh, microbatches=microbatches
        )
        return film_sum + radiance, None

    film_sum, _ = jax.lax.scan(
        sample_step, jnp.zeros((r, 3), jnp.float32), jnp.arange(settings.spp)
    )
    return (film_sum / settings.spp).reshape(h, w, 3)
