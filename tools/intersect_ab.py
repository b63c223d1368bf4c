"""Closest-hit A/B on the GPU at config-3 shape: Pallas kernel vs XLA scan.

    python tools/intersect_ab.py [--tiles 32,64,128] [--blocks 32,64,128]

Builds the config-3 scene with its mesh replaced by the icosphere (see
chip_smoke.py), 640k primary rays and one bounce of diffuse secondaries,
and for each ray set times (block_until_ready, median of 5):

- the Pallas kernel (ops/pallas_intersect) for every (ray_tile, tri_block)
  pair, with its hit agreement against the XLA Plücker scan;
- the XLA Plücker scan (ops/plucker, exact f32);
- the stackless BVH (accel/bvh), once.

Prints one JSON line per measurement, with the card's name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        )
    except FileNotFoundError:
        return "no nvidia-smi"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def timed(fn, *args, iters=5):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def rays(scene, camera):
    from gpupathtracer_tpu.models.camera import generate_rays
    from gpupathtracer_tpu.ops import plucker, sampling
    from gpupathtracer_tpu.ops.intersect import resolve_hits

    o, d = generate_rays(camera)
    packed = plucker.pack_triangles(scene, tri_block=128)
    h0 = jax.jit(lambda a, b: plucker.intersect_plucker_jnp(a, b, packed))(o, d)
    attrs = resolve_hits(o, d, scene, h0.tri)
    sampler = sampling.make_sampler("pcg")
    keys = sampler.path_keys(jax.random.PRNGKey(3), jnp.arange(o.shape[0], dtype=jnp.uint32), 0)
    u = sampler.uniform(keys, 2)
    n = attrs.gn * -jnp.sign(jnp.sum(d * attrs.gn, axis=-1, keepdims=True))
    d2 = sampling.local_to_world(sampling.cosine_sample_hemisphere(u[:, 0], u[:, 1]), n)
    o2 = jnp.where(h0.hit[:, None], attrs.point + 1e-4 * n, o)
    d2 = jnp.where(h0.hit[:, None], d2, d)
    return {"primary": (o, d), "secondary": (o2, d2)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--tiles", default="32,64,128")
    p.add_argument("--blocks", default="32,64,128")
    p.add_argument("--no-bvh", action="store_true")
    p.add_argument("--size", type=int, default=800, help="image side (rays = size²)")
    args = p.parse_args()

    import chip_smoke
    from gpupathtracer_tpu.ops import pallas_intersect as pi, plucker
    from gpupathtracer_tpu.utils.config import load_scene_file
    from gpupathtracer_tpu.utils.debug import enable_compile_cache

    enable_compile_cache()
    gpu = card()
    emit = lambda **kw: print(json.dumps({**kw, "card": gpu}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        toml = os.path.join(tmp, "c3.toml")
        chip_smoke.config3_sphere_toml(toml)
        scene, camera, _ = load_scene_file(toml)
    camera = camera.replace(width=args.size, height=args.size)
    ray_sets = rays(scene, camera)
    xla_packed = plucker.pack_triangles(scene, tri_block=128)
    for name, (o, d) in ray_sets.items():
        n = o.shape[0]
        xla = jax.jit(lambda a, b: plucker.intersect_plucker_jnp(a, b, xla_packed, ray_chunk=8192))
        h_ref = xla(o, d)
        emit(what="xla_plucker", rays=name, n=n, seconds=timed(xla, o, d))
        for tb in [int(x) for x in args.blocks.split(",")]:
            packed = pi.pack_scene(scene, tri_block=tb)
            for tr in [int(x) for x in args.tiles.split(",")]:
                try:
                    fn = jax.jit(lambda a, b, packed=packed, tr=tr: pi.intersect_pallas(
                        a, b, packed, ray_tile=tr))
                    h = fn(o, d)
                    agree = float(np.mean(np.asarray(h.tri) == np.asarray(h_ref.tri)))
                    emit(what="kernel", rays=name, n=n, ray_tile=tr, tri_block=tb,
                         agreement=agree, seconds=timed(fn, o, d))
                except Exception as e:  # report and go on to the next shape
                    emit(what="kernel", rays=name, ray_tile=tr, tri_block=tb,
                         error=f"{type(e).__name__}: {e}"[:2000])
        occ_cut = jnp.where(jnp.arange(n) % 4 == 0, 0.0, 0.5 * jnp.clip(h_ref.t, 0.0, 50.0) + 1.0)
        try:
            packed = pi.pack_scene(scene)
            occ = jax.jit(lambda a, b, c: pi.intersect_pallas_occluded(a, b, c, packed))
            ref = np.asarray(h_ref.hit & (h_ref.t < occ_cut))
            agree = float(np.mean(np.asarray(occ(o, d, occ_cut)) == ref))
            emit(what="kernel_any_hit", rays=name, agreement=agree,
                 seconds=timed(occ, o, d, occ_cut))
        except Exception as e:
            emit(what="kernel_any_hit", rays=name, error=f"{type(e).__name__}: {e}"[:2000])
        if not args.no_bvh:
            from gpupathtracer_tpu.accel.bvh import build_bvh, intersect_bvh

            bvh = build_bvh(scene)
            fn = jax.jit(lambda a, b: intersect_bvh(a, b, scene, bvh))
            agree = float(np.mean(np.asarray(fn(o, d).tri) == np.asarray(h_ref.tri)))
            emit(what="bvh", rays=name, agreement=agree, seconds=timed(fn, o, d, iters=2))


if __name__ == "__main__":
    main()
