"""Benchmark harness: rays/sec across the BASELINE workload suite.

Prints ONE JSON line whose headline fields ({"metric", "value", "unit",
"vs_baseline"}) keep the config-3 forward rays/s axis (the reference's own
default frame regime, kernel.cu:262-266), with the wider suite nested
alongside:

- ``configs``: forward AND forward+backward rays/s for every BASELINE
  config (1-5) plus the large-scene configs 6-8;
- the reference publishes no numbers (BASELINE.json "published": {}), so
  vs_baseline is measured against this repo's own first light
  (ROUND1_RAYS_PER_SEC).

Every timed call ends in ``jax.block_until_ready``; each iteration varies
the seed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time

# First light of the brute-force jnp intersector: the fixed reference of
# vs_baseline.
ROUND1_RAYS_PER_SEC = 3.2e6

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")

# Full-suite detail lands here; main() nulls the compact line's "detail"
# field if the write fails so a stale file is never mistaken for this run's.
DETAIL_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "BENCH_DETAIL.json"
)

# (config file, bench spp, bench resolution override or None)
CONFIG_SUITE = [
    ("config1_triangle.toml", 16, None),
    ("config2_cornell.toml", 4, None),
    ("config3_wahoo.toml", 4, None),
    ("config4_occlusion.toml", 4, None),
    ("config5_invert_target.toml", 8, None),
    ("config6_bigscene.toml", 2, None),
    ("config7_hugescene.toml", 1, None),
    ("config8_textured.toml", 4, None),
]

# Configs whose BASELINE.json spec spp gets one full end-to-end run,
# chunked through render_samples (32-spp executables). config3's spec run
# keeps its slot in run_benchmark; these add the remaining spec workloads.
# Skippable with FIREFLY_SKIP_SPEC_SPP=1 when bench wall-time is tight.
SPEC_SPP_SUITE = ["config2_cornell.toml", "config4_occlusion.toml"]


def _timed(step, iters: int, warmup: int = 1):
    t0 = time.perf_counter()
    for i in range(max(warmup, 1)):
        step(i)
    compile_s = time.perf_counter() - t0
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        step(100 + i)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), compile_s


def _bench_frame(scene, camera, settings, iters: int):
    import jax
    import jax.numpy as jnp

    from gpupathtracer_tpu.render.renderer import render_frame

    def step(i):
        return jax.block_until_ready(
            render_frame(scene, camera, settings, seed=jnp.uint32(1000 + i))
        )

    dt, compile_s = _timed(step, iters)
    rays = settings.width * settings.height * settings.spp * settings.bounces
    return {
        "rays_per_sec": round(rays / dt, 1),
        "median_s": round(dt, 4),
        "warmup_s": round(compile_s, 2),
        "spp": settings.spp,
        "bounces": settings.bounces,
        "resolution": [settings.width, settings.height],
    }


def _bench_backward(scene, camera, settings, iters: int):
    """Forward+backward rays/sec: grad of an image loss wrt materials +
    vertices through the full estimator, at the SAME spp as the forward
    bench so per-config fwd vs fwd+bwd ratios are apples-to-apples."""
    import jax
    import jax.numpy as jnp

    from gpupathtracer_tpu.render.renderer import render_frame

    def loss(v0, albedo, seed):
        s = scene.replace(v0=v0, materials=scene.materials.replace(albedo=albedo))
        return jnp.mean(render_frame(s, camera, settings, seed=seed))

    grad_fn = jax.jit(jax.grad(loss, argnums=(0, 1)))

    def step(i):
        return jax.block_until_ready(grad_fn(scene.v0, scene.materials.albedo, jnp.uint32(i)))

    dt, compile_s = _timed(step, iters)
    rays = settings.width * settings.height * settings.spp * settings.bounces
    return {
        "rays_per_sec": round(rays / dt, 1),
        "median_s": round(dt, 4),
        "warmup_s": round(compile_s, 2),
        "spp": settings.spp,
    }


def run_benchmark(
    scene_path: str | None = None,
    warmup: int = 1,
    iters: int = 3,
    spp: int = 4,
    backward: bool = True,
    full_suite: bool = True,
):
    import jax

    from gpupathtracer_tpu.utils.config import load_scene_file
    from gpupathtracer_tpu.utils.debug import enable_compile_cache

    enable_compile_cache()
    t_bench_start = time.perf_counter()

    # Headline: config-3 forward (round-1 comparability axis).
    scene_path = scene_path or os.path.join(SCENES, "config3_wahoo.toml")
    scene, camera, settings = load_scene_file(scene_path)
    settings = dataclasses.replace(settings, spp=spp)
    head = _bench_frame(scene, camera, settings, iters)

    result = {
        "metric": "rays_per_sec_chip_fwd",
        "value": head["rays_per_sec"],
        "unit": "rays/s",
        "vs_baseline": round(head["rays_per_sec"] / ROUND1_RAYS_PER_SEC, 3),
        "config": os.path.basename(scene_path),
        "median_s": head["median_s"],
        "warmup_s": head["warmup_s"],
        "spp": settings.spp,
        "bounces": settings.bounces,
        "resolution": [settings.width, settings.height],
        "device": str(jax.devices()[0]),
    }

    if backward:
        result["fwd_bwd"] = _bench_backward(scene, camera, settings, iters)

    if full_suite:
        configs = {}
        for fname, cfg_spp, _res in CONFIG_SUITE:
            path = os.path.join(SCENES, fname)
            if os.path.abspath(path) == os.path.abspath(scene_path):
                configs[fname] = {**head, "fwd_bwd": result.get("fwd_bwd")}
                continue
            try:
                sc, cam, st = load_scene_file(path)
                st = dataclasses.replace(st, spp=cfg_spp)
                entry = _bench_frame(sc, cam, st, iters=max(iters - 1, 1))
                entry["fwd_bwd"] = _bench_backward(sc, cam, st, iters=max(iters - 1, 1))
            except Exception as e:  # keep the suite robust per-config
                entry = {"error": f"{type(e).__name__}: {e}"[:200]}
            configs[fname] = entry
        result["configs"] = configs

    # Full-spec-spp runs: the BASELINE.json spp targets exercised
    # end-to-end, CHUNKED through render_samples (32-spp executables;
    # sample-chunk sums are bit-identical to the one-shot frame). Runs LAST
    # + guarded so a fault cannot take down the rest of the suite's numbers.
    # Wall-clock budget guard: the spec-spp rows are the most expensive
    # part; if the suite above already burned the budget, skip the remaining
    # spec rows with a note instead of timing out with NO output.
    budget_s = float(os.environ.get("FIREFLY_BENCH_BUDGET_S", "2400"))
    skip_spec = os.environ.get("FIREFLY_SKIP_SPEC_SPP") == "1"

    def over_budget():
        return time.perf_counter() - t_bench_start > budget_s

    try:
        _, _, st_spec = load_scene_file(scene_path)
        if st_spec.spp > spp and not skip_spec:
            if over_budget():
                result["full_spp"] = {"skipped": "bench budget exceeded"}
            else:
                result["full_spp"] = _bench_full_spp(scene, camera, settings, st_spec.spp)
    except Exception as e:
        result["full_spp"] = {"error": f"{type(e).__name__}: {e}"[:200]}
    if full_suite and not skip_spec:
        for fname in SPEC_SPP_SUITE:
            path = os.path.join(SCENES, fname)
            if os.path.abspath(path) == os.path.abspath(scene_path):
                continue
            try:
                if over_budget():
                    entry = {"skipped": "bench budget exceeded"}
                else:
                    sc, cam, st = load_scene_file(path)
                    if st.spp <= 4:
                        continue
                    entry = _bench_full_spp(sc, cam, st, st.spp)
                result.setdefault("configs", {}).setdefault(fname, {})["full_spp"] = entry
            except Exception as e:
                result.setdefault("configs", {}).setdefault(fname, {})["full_spp"] = {
                    "error": f"{type(e).__name__}: {e}"[:200]
                }

    return result


def _bench_full_spp(scene, camera, settings, spec_spp: int, chunk: int = 32):
    """One frame at the config's SPEC spp, summed over 32-spp chunks."""
    import jax
    import jax.numpy as jnp

    from gpupathtracer_tpu.render.renderer import render_samples

    full = dataclasses.replace(settings, spp=spec_spp)

    def step(i):
        for s0 in range(0, spec_spp, chunk):
            n = min(chunk, spec_spp - s0)
            jax.block_until_ready(
                render_samples(
                    scene, camera, full, jnp.uint32(s0), n, seed=jnp.uint32(500 + i)
                )
            )

    # Warm up on ONE chunk (every later chunk reuses its executable) then
    # time a single full pass — a 1024-spp config is minutes per pass, so
    # the usual warmup+median protocol would double a long run for ~nothing.
    # The warmup MUST pass a seed: seed=None traces a different executable
    # signature and the timed pass would re-compile.
    t0 = time.perf_counter()
    jax.block_until_ready(
        render_samples(
            scene, camera, full, jnp.uint32(0), min(chunk, spec_spp), seed=jnp.uint32(500)
        )
    )
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step(1)
    dt = time.perf_counter() - t0
    rays = full.width * full.height * spec_spp * full.bounces
    return {
        "rays_per_sec": round(rays / dt, 1),
        "median_s": round(dt, 4),
        "warmup_s": round(compile_s, 2),
        "spp": spec_spp,
        "chunked": chunk,
    }


def run_scaling_probe(n_devices: int = 8):
    """Mesh-scaling structure check on virtual CPU devices (no perf claim)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import __graft_entry__ as ge

    ge.dryrun_multichip(n_devices)


def main():
    import sys

    result = run_benchmark()
    # Full suite detail goes to a file; stdout gets ONE compact JSON line
    # (last line) so the driver's parser never chokes on a multi-KB blob.
    detail_name = os.path.basename(DETAIL_PATH)
    try:
        with open(DETAIL_PATH, "w") as f:
            json.dump(result, f, indent=1)
    except OSError as e:
        print(f"warning: could not write {DETAIL_PATH}: {e}", file=sys.stderr)
        from gpupathtracer_tpu.utils.metrics import log_runtime_event

        log_runtime_event(
            {"event": "bench_detail_write_failed", "path": DETAIL_PATH, "error": str(e)}
        )
        detail_name = None  # any existing detail file is NOT from this run
    compact = {
        "metric": result["metric"],
        "value": result["value"],
        "unit": result["unit"],
        "vs_baseline": result["vs_baseline"],
        "config": result.get("config"),
        "fwd_bwd_rays_per_sec": (result.get("fwd_bwd") or {}).get("rays_per_sec"),
        "detail": detail_name,
    }
    print(json.dumps(compact))


if __name__ == "__main__":
    main()
