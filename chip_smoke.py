"""Smoke test of the path tracer on one NVIDIA GPU, through its user entry points.

    python chip_smoke.py               # phases 1-5 on one GPU
    python chip_smoke.py --four-cards  # only the 4-GPU distributed phase

Phases (one process; the first failure exits non-zero):

1. device   — require a GPU; print the card's name and power limit, the JAX
              version, XLA_FLAGS and the compile-cache directory.
2. render   — ``firefly render`` (cli.main) of the config-3 scene at 800x800,
              spp 4, 4 bounces, intersector "auto"; decode the PNG, check it.
3. timed    — the same frame through load_scene_file + render_frame, timed
              with block_until_ready; seconds per frame, path segments per
              second (W·H·spp·bounces / s) and peak device memory.
4. oracle   — the default closest hit and NEE occlusion query against the
              Möller–Trumbore oracle (ops/intersect.py) on 640k primary rays
              and one bounce of diffuse secondaries; the Pallas kernel also
              against the XLA Plücker scan.
5. grad     — ``firefly invert --steps 3`` (Adam on the config-5 job, NEE),
              then one timed jax.grad of a mean-image loss w.r.t. vertices and
              albedo at 256x256, spp 2.

``--four-cards`` renders the phase-2 scene at 256x256, spp 2 with
parallel.render.render_frame_distributed on a (4, 1) mesh and on a (2, 2)
mesh with each scene strategy, compares each with the one-card render_frame,
then runs the data-parallel Adam step of __graft_entry__.dryrun_multichip(4).

The config-3 scene's mesh (wahoo.obj, 5,172 triangles) is not in the
repository; this script replaces it by the procedural icosphere at
subdivision 4 (20·4⁴ = 5,120 triangles) of radius SPHERE_RADIUS at the same
position and material. The last stdout line is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG3 = os.path.join(REPO, "scenes", "config3_wahoo.toml")
SPHERE_RADIUS = 1.5
SPHERE_SUBDIVISIONS = 4
# Image side of the gradient and four-card phases.
SMALL_SIZE = 256

# Oracle thresholds (tests/test_plucker.py): triangle ids agree on more than
# 99.9% of rays; on agreeing hits t agrees to RTOL/ATOL.
MIN_AGREEMENT = 0.999
ORACLE_TOL = 1e-4
KERNEL_VS_XLA_TOL = 1e-5

# Four-card renders against the one-card frame. Pixels are sharded but every
# lane's arithmetic is the same, so the (4, 1) and (2, 2) renders are
# expected to be bit-identical. XLA compiles the sharded program for other
# local shapes than the one-card program and may pick other fusions, so a
# frame that is not bit-identical is still accepted if it agrees to FOUR_TOL
# (absolute, radiance units): differences then come from float rounding of
# reordered sums in shading and accumulation, not from different hits.
FOUR_TOL = 1e-5


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def config3_sphere_toml(path: str) -> None:
    """Write config3_wahoo.toml with its OBJ mesh replaced by the icosphere."""
    with open(CONFIG3) as f:
        text = f.read()
    mesh_block = re.compile(r'kind = "mesh"\nobj = "wahoo.obj"\n')
    check(len(mesh_block.findall(text)) == 1, "config3 no longer names wahoo.obj once")
    text = mesh_block.sub(
        f'kind = "sphere"\nradius = {SPHERE_RADIUS}\nsubdivisions = {SPHERE_SUBDIVISIONS}\n',
        text,
    )
    # The wahoo block's uniform scale applied to the OBJ; the sphere's size is
    # its radius.
    text = text.replace("scale = 0.55\n", "")
    with open(path, "w") as f:
        f.write(text)


def phase_device(jax):
    devs = jax.devices()
    platform = devs[0].platform
    check(platform == "gpu", f"JAX found no GPU (platform {platform!r})")
    from gpupathtracer_tpu.utils.debug import enable_compile_cache

    cache = enable_compile_cache()
    card = nvidia_smi()
    say(card)
    say(f"jax {jax.__version__}")
    say(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')}")
    say(f"compile cache: {cache}")
    say(f"devices: {len(devs)} x {devs[0].device_kind}")
    return card


def phase_render(toml: str, tmp: str) -> None:
    import numpy as np

    from gpupathtracer_tpu import cli
    from gpupathtracer_tpu.utils.image import read_png

    png = os.path.join(tmp, "config3_sphere.png")
    from gpupathtracer_tpu.utils.config import load_scene_file

    _, _, settings = load_scene_file(toml)
    rc = cli.main(["render", toml, "--out", png, "--spp", "4"])
    check(rc == 0, f"cli render returned {rc}")
    img = read_png(png)
    want = (settings.height, settings.width, 3)
    check(img.shape == want, f"rendered image has shape {img.shape}, not {want}")
    check(np.isfinite(img.astype(np.float32)).all(), "rendered image is not finite")
    check(int(img.max()) > 0, "rendered image is all black")
    say(f"render: {png} {img.shape} mean={float(img.mean()):.3f} max={int(img.max())}")


def phase_timed(jax, toml: str, card: str):
    import dataclasses

    import numpy as np

    from gpupathtracer_tpu.render.integrator import resolved_intersector
    from gpupathtracer_tpu.render.renderer import _integrator_options, render_frame
    from gpupathtracer_tpu.utils.config import load_scene_file

    scene, camera, settings = load_scene_file(toml)
    check(settings.intersector == "auto", "config3 no longer uses the auto intersector")
    settings = dataclasses.replace(settings, spp=4)
    which = resolved_intersector(_integrator_options(settings))
    seed = jax.numpy.uint32(7)
    img = jax.block_until_ready(render_frame(scene, camera, settings, seed=seed))
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        img = jax.block_until_ready(
            render_frame(scene, camera, settings, seed=jax.numpy.uint32(100 + i))
        )
        times.append(time.perf_counter() - t0)
    check(bool(np.isfinite(np.asarray(img)).all()), "timed frame is not finite")
    dt = sorted(times)[1]
    segs = settings.width * settings.height * settings.spp * settings.bounces
    say(
        f"timed: {settings.width}x{settings.height} spp={settings.spp} "
        f"bounces={settings.bounces} intersector={which} "
        f"s/frame={dt} (runs {times}) segments/s={segs / dt} card={card}"
    )
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    say(f"peak_bytes_in_use={peak}")
    return scene, camera, settings


def _agreement(h_ref, h, tol):
    import numpy as np

    tri_ref = np.asarray(h_ref.tri)
    tri = np.asarray(h.tri)
    agree = tri_ref == tri
    same = agree & np.asarray(h_ref.hit)
    t_ref = np.asarray(h_ref.t)[same]
    t = np.asarray(h.t)[same]
    t_ok = bool(np.all(np.abs(t - t_ref) <= tol + tol * np.abs(t_ref)))
    return float(agree.mean()), t_ok


def phase_oracle(jax, scene, camera, settings):
    import jax.numpy as jnp
    import numpy as np

    from gpupathtracer_tpu.models.camera import generate_rays
    from gpupathtracer_tpu.ops import pallas_intersect, plucker, sampling
    from gpupathtracer_tpu.ops.intersect import intersect_brute, resolve_hits
    from gpupathtracer_tpu.render.integrator import (
        make_intersect_fn,
        make_occlusion_fn,
        resolved_intersector,
    )
    from gpupathtracer_tpu.render.renderer import _integrator_options

    opts = _integrator_options(settings)
    which = resolved_intersector(opts)
    say(f"oracle: default intersector={which} "
        f"matmul precision={jax.config.jax_default_matmul_precision}")
    default_fn = jax.jit(lambda o, d: make_intersect_fn(scene, opts)(o, d, scene))
    brute_fn = jax.jit(lambda o, d: intersect_brute(o, d, scene, tri_block=settings.tri_block))

    # 640k primary rays and one bounce of cosine-sampled diffuse secondaries
    # from their hits (misses keep their primary ray).
    o, d = generate_rays(camera)
    h0 = brute_fn(o, d)
    attrs = resolve_hits(o, d, scene, h0.tri)
    sampler = sampling.make_sampler("pcg")
    keys = sampler.path_keys(jax.random.PRNGKey(3), jnp.arange(o.shape[0], dtype=jnp.uint32), 0)
    u = sampler.uniform(keys, 2)
    n = attrs.gn * -jnp.sign(jnp.sum(d * attrs.gn, axis=-1, keepdims=True))
    d2 = sampling.local_to_world(sampling.cosine_sample_hemisphere(u[:, 0], u[:, 1]), n)
    o2 = jnp.where(h0.hit[:, None], attrs.point + 1e-4 * n, o)
    d2 = jnp.where(h0.hit[:, None], d2, d)

    for name, (oo, dd) in (("primary", (o, d)), ("secondary", (o2, d2))):
        h_ref = h0 if name == "primary" else brute_fn(oo, dd)
        h = default_fn(oo, dd)
        frac, t_ok = _agreement(h_ref, h, ORACLE_TOL)
        say(f"oracle {name}: rays={oo.shape[0]} hits={int(h_ref.hit.sum())} "
            f"tri agreement={frac} t within {ORACLE_TOL}: {t_ok}")
        check(frac > MIN_AGREEMENT, f"{name} hit agreement {frac} <= {MIN_AGREEMENT}")
        check(t_ok, f"{name} hit distances differ from the oracle beyond {ORACLE_TOL}")

        # NEE occlusion predicate: any accepted hit closer than a cutoff.
        # Cutoffs just before or just after each true hit (misses: a finite
        # cutoff); every 4th lane dead (cutoff 0, must report unoccluded).
        lane = jnp.arange(oo.shape[0])
        cut = jnp.where(h_ref.hit, h_ref.t * jnp.where(lane % 2 == 0, 0.9, 1.1), 20.0)
        cut = jnp.where(lane % 4 == 0, 0.0, cut)
        occ_fn = make_occlusion_fn(scene, opts, make_intersect_fn(scene, opts))
        occ = np.asarray(jax.jit(occ_fn)(oo, dd, cut))
        occ_ref = np.asarray(h_ref.hit & (h_ref.t < cut))
        occ_frac = float((occ == occ_ref).mean())
        say(f"oracle {name} occlusion: agreement={occ_frac} occluded={int(occ_ref.sum())}")
        check(occ_frac > MIN_AGREEMENT, f"{name} occlusion agreement {occ_frac}")

        if which == "pallas":
            packed = plucker.pack_triangles(scene, tri_block=settings.tri_block)
            h_xla = jax.jit(lambda a, b: plucker.intersect_plucker_jnp(a, b, packed))(oo, dd)
            h_k = jax.jit(
                lambda a, b: pallas_intersect.intersect_pallas(
                    a, b, pallas_intersect.pack_scene(scene)
                )
            )(oo, dd)
            frac, t_ok = _agreement(h_xla, h_k, KERNEL_VS_XLA_TOL)
            say(f"kernel vs XLA plucker {name}: tri agreement={frac} "
                f"t within {KERNEL_VS_XLA_TOL}: {t_ok}")
            check(frac > MIN_AGREEMENT, f"kernel vs XLA {name} agreement {frac}")
            check(t_ok, f"kernel vs XLA {name}: t beyond {KERNEL_VS_XLA_TOL}")


def phase_grad(jax, scene, camera, settings, tmp: str) -> None:
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from gpupathtracer_tpu import cli
    from gpupathtracer_tpu.render.renderer import render_frame

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["invert", "--steps", "3", "--out", os.path.join(tmp, "invert")])
    check(rc == 0, f"cli invert returned {rc}")
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    losses = [loss for _, loss in result["loss_history"]]
    say(f"invert: losses={losses}")
    check(len(losses) == 3, f"expected 3 step losses, got {len(losses)}")
    check(all(np.isfinite(losses)), "invert produced a non-finite loss")

    st = dataclasses.replace(settings, width=SMALL_SIZE, height=SMALL_SIZE, spp=2)
    cam = camera.replace(width=SMALL_SIZE, height=SMALL_SIZE)

    def loss(v0, albedo):
        s = scene.replace(v0=v0, materials=scene.materials.replace(albedo=albedo))
        return jnp.mean(render_frame(s, cam, st, seed=jnp.uint32(5)))

    grad_fn = jax.jit(jax.grad(loss, argnums=(0, 1)))
    args = (scene.v0, scene.materials.albedo)
    jax.block_until_ready(grad_fn(*args))
    t0 = time.perf_counter()
    g_v0, g_alb = jax.block_until_ready(grad_fn(*args))
    dt = time.perf_counter() - t0
    g_v0, g_alb = np.asarray(g_v0), np.asarray(g_alb)
    say(f"grad: {SMALL_SIZE}x{SMALL_SIZE} spp=2 bounces={st.bounces} seconds={dt} "
        f"|g_v0|={float(np.abs(g_v0).sum())} |g_albedo|={float(np.abs(g_alb).sum())}")
    check(np.isfinite(g_v0).all() and np.isfinite(g_alb).all(), "non-finite gradient")
    check(np.abs(g_alb).sum() > 0, "albedo gradient is zero")


def phase_four_cards(jax, toml: str) -> None:
    import dataclasses

    import numpy as np

    import __graft_entry__
    from gpupathtracer_tpu.parallel.mesh import make_mesh
    from gpupathtracer_tpu.parallel.render import render_frame_distributed
    from gpupathtracer_tpu.render.renderer import render_frame
    from gpupathtracer_tpu.utils.config import load_scene_file

    devs = jax.devices()
    check(len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}")
    devs = devs[:4]
    check(len({d.id for d in devs}) == 4, "device ids are not distinct")
    # Rows padded so that each of two scene shards holds whole blocks.
    _, _, settings = load_scene_file(toml)
    scene, camera, settings = load_scene_file(toml, pad_to_multiple=2 * settings.tri_block)
    settings = dataclasses.replace(settings, width=SMALL_SIZE, height=SMALL_SIZE, spp=2)
    camera = camera.replace(width=SMALL_SIZE, height=SMALL_SIZE)
    ref = np.asarray(jax.block_until_ready(render_frame(scene, camera, settings)))
    check(np.isfinite(ref).all(), "one-card reference frame is not finite")
    cases = [((4, 1), "allgather")] + [((2, 2), s) for s in ("allgather", "ring", "ulysses")]
    for (n_data, n_scene), strategy in cases:
        mesh = make_mesh(n_data=n_data, n_scene=n_scene, devices=devs)
        img = jax.block_until_ready(
            render_frame_distributed(scene, camera, settings, mesh, scene_strategy=strategy)
        )
        used = {d.id for d in img.sharding.device_set}
        mesh_ids = {d.id for d in mesh.devices.flat}
        check(mesh_ids == {d.id for d in devs}, f"mesh {mesh.devices} is not the 4 cards")
        t0 = time.perf_counter()
        img = jax.block_until_ready(
            render_frame_distributed(scene, camera, settings, mesh, scene_strategy=strategy)
        )
        dt = time.perf_counter() - t0
        out = np.asarray(img)
        diff = float(np.abs(out - ref).max())
        identical = bool(np.array_equal(out, ref))
        say(f"four-cards mesh=({n_data}x{n_scene}) strategy={strategy} "
            f"output devices={sorted(used)} bit-identical={identical} "
            f"max|diff|={diff} seconds={dt}")
        check(identical or diff <= FOUR_TOL, f"{strategy} differs from one card by {diff}")
    __graft_entry__.dryrun_multichip(4)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--four-cards", action="store_true",
        help="run only the 4-GPU distributed phase",
    )
    args = p.parse_args(argv)
    try:
        import jax

        sys.path.insert(0, REPO)
        import gpupathtracer_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: FAILED: cannot import the path tracer ({e})", file=sys.stderr)
        return 1

    try:
        card = phase_device(jax)
        with tempfile.TemporaryDirectory() as tmp:
            toml = os.path.join(tmp, "config3_sphere.toml")
            config3_sphere_toml(toml)
            if args.four_cards:
                phase_four_cards(jax, toml)
            else:
                phase_render(toml, tmp)
                scene, camera, settings = phase_timed(jax, toml, card)
                phase_oracle(jax, scene, camera, settings)
                phase_grad(jax, scene, camera, settings, tmp)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    devs = jax.devices()
    say(json.dumps({
        "ok": True,
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
