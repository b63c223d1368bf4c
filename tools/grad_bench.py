"""Forward vs forward+backward frame time on the large scenes (configs 6
and 7) and config 3, on the GPU:

    python tools/grad_bench.py

Prints one JSON line per measurement; every timed call ends in
jax.block_until_ready.
"""

import dataclasses
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from gpupathtracer_tpu.render.renderer import render_frame
from gpupathtracer_tpu.utils.config import load_scene_file
from gpupathtracer_tpu.utils.debug import enable_compile_cache

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


def timed(step, iters=2):
    t0 = time.perf_counter()
    step(0)
    compile_s = time.perf_counter() - t0
    ts = []
    for i in range(iters):
        t0 = time.perf_counter()
        step(100 + i)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), compile_s


def bench_config(fname, spp, iters=2):
    scene, camera, settings = load_scene_file(os.path.join(SCENES, fname))
    settings = dataclasses.replace(settings, spp=spp)
    rays = settings.width * settings.height * settings.spp * settings.bounces

    def fwd_step(i):
        return jax.block_until_ready(
            render_frame(scene, camera, settings, seed=jnp.uint32(1000 + i))
        )

    dt, cs = timed(fwd_step, iters)
    print(json.dumps({"config": fname, "mode": "fwd", "median_s": round(dt, 3),
                      "rays_per_sec": round(rays / dt, 1), "compile_s": round(cs, 1)}), flush=True)

    def loss(v0, albedo, seed):
        s = scene.replace(v0=v0, materials=scene.materials.replace(albedo=albedo))
        return jnp.mean(render_frame(s, camera, settings, seed=seed))

    grad_fn = jax.jit(jax.grad(loss, argnums=(0, 1)))

    def bwd_step(i):
        return jax.block_until_ready(grad_fn(scene.v0, scene.materials.albedo, jnp.uint32(i)))

    dt2, cs2 = timed(bwd_step, iters)
    print(json.dumps({"config": fname, "mode": "fwd_bwd", "median_s": round(dt2, 3),
                      "rays_per_sec": round(rays / dt2, 1), "compile_s": round(cs2, 1),
                      "bwd_over_fwd": round(dt2 / dt, 2)}), flush=True)


if __name__ == "__main__":
    enable_compile_cache()
    print(json.dumps({"device": str(jax.devices()[0])}), flush=True)
    for fname, spp in [("config6_bigscene.toml", 2), ("config7_hugescene.toml", 1), ("config3_wahoo.toml", 4)]:
        try:
            bench_config(fname, spp)
        except Exception as e:
            print(json.dumps({"config": fname, "error": f"{type(e).__name__}: {e}"[:300]}), flush=True)
