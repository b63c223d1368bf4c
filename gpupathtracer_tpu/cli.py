"""CLI: ``firefly render|benchmark|invert`` — the reference's main() as verbs.

Replaces the reference's interactive GLFW loop + Ctrl-S PPM dump
(kernel.cu:331-359, utilities.h:858-893) with offline file rendering; the
viewer layer is a host-side framebuffer write (SURVEY.md §1 L5 mapping).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_render(args) -> int:
    import dataclasses

    import numpy as np

    from gpupathtracer_tpu.render import film
    from gpupathtracer_tpu.render.renderer import render_frame
    from gpupathtracer_tpu.utils.config import load_scene_file
    from gpupathtracer_tpu.utils.image import write_image
    from gpupathtracer_tpu.utils.profiling import trace

    scene, camera, settings = load_scene_file(args.scene)
    overrides = {}
    if args.spp:
        overrides["spp"] = args.spp
    if args.aov:
        overrides["aov"] = args.aov
    if args.estimator:
        overrides["estimator"] = args.estimator
    if args.intersector:
        overrides["intersector"] = args.intersector
    if overrides:
        settings = dataclasses.replace(settings, **overrides)
    t0 = time.perf_counter()
    with trace(args.profile_dir):
        if args.checkpoint or args.chunk_spp:
            from gpupathtracer_tpu.render.progressive import render_progressive

            img = render_progressive(
                scene,
                camera,
                settings,
                chunk_spp=args.chunk_spp or 16,
                checkpoint_path=args.checkpoint,
                metrics_path=args.metrics,
            )
        else:
            img = np.asarray(render_frame(scene, camera, settings))
    t1 = time.perf_counter()
    write_image(args.out, film.to_u8(img, gamma=args.gamma))
    spp_eff = 1 if settings.aov != "radiance" else settings.spp
    bounces_eff = 1 if settings.aov != "radiance" else settings.bounces
    rays = settings.width * settings.height * spp_eff * bounces_eff
    print(
        f"rendered {settings.width}x{settings.height} spp={settings.spp} "
        f"bounces={settings.bounces} in {t1 - t0:.3f}s "
        f"({rays / (t1 - t0) / 1e6:.1f} Mrays/s incl. compile) -> {args.out}"
    )
    return 0


def cmd_benchmark(args) -> int:
    from gpupathtracer_tpu.bench import run_benchmark

    result = run_benchmark(
        scene_path=args.scene, warmup=args.warmup, iters=args.iters,
        backward=args.full, full_suite=args.full,
    )
    print(json.dumps(result))
    return 0


def cmd_view(args) -> int:
    """Viewer verbs. Default: turntable orbit → PNG frame sequence.

    ``--live``: progressive live preview — chunks of samples accumulate
    into an atomically refreshed ``live.png`` (+ auto-reloading HTTP page
    with ``--http PORT``), camera driven by stdin commands
    (w/s/a/d/q/e/left/right/up/down/`mouse dx dy`/r/quit — the reference's
    WASD/arrow/mouse controls, utilities.h:858-893, over the same ported
    Camera model). Closes the reference's GLFW viewer capability
    (utilities.h:434-778) without GL.
    """
    import dataclasses
    import os

    if args.live:
        from gpupathtracer_tpu.render.live import live_view
        from gpupathtracer_tpu.utils.config import load_scene_file

        scene, camera, settings = load_scene_file(args.scene)
        if args.spp:
            settings = dataclasses.replace(settings, spp=args.spp)
        print(
            f"live preview -> {args.out}/live.png"
            + (f" (http://127.0.0.1:{args.http})" if args.http else "")
            + "; commands on stdin: w/s/a/d/q/e left/right/up/down 'mouse dx dy' r quit",
            flush=True,
        )
        cam, spp_done = live_view(
            scene, camera, settings, args.out,
            chunk_spp=args.chunk_spp, max_spp=args.max_spp,
            http_port=args.http, gamma=args.gamma,
        )
        print(f"live view done ({spp_done} spp at exit)")
        return 0

    import numpy as np

    from gpupathtracer_tpu.models.camera import Camera
    from gpupathtracer_tpu.render import film
    from gpupathtracer_tpu.render.renderer import render_frame
    from gpupathtracer_tpu.utils.config import load_scene_file
    from gpupathtracer_tpu.utils.image import write_png

    scene, camera, settings = load_scene_file(args.scene)
    if args.spp:
        settings = dataclasses.replace(settings, spp=args.spp)
    os.makedirs(args.out, exist_ok=True)
    pos0 = np.asarray(camera.position)
    # Orbit about the world-up axis through the origin at the camera radius.
    radius = float(np.linalg.norm(pos0[[0, 2]]))
    base_angle = float(np.arctan2(pos0[2], pos0[0]))
    frames = []
    t0 = time.perf_counter()
    for i in range(args.frames):
        ang = base_angle + 2.0 * np.pi * i / args.frames
        pos = np.asarray([radius * np.cos(ang), pos0[1], radius * np.sin(ang)], np.float32)
        yaw = np.degrees(ang) + 180.0  # look back at the origin
        cam = camera.replace(
            position=pos.astype(np.float32), yaw=np.float32(yaw)
        )
        img = np.asarray(render_frame(scene, cam, settings))
        frame_path = os.path.join(args.out, f"frame_{i:04d}.png")
        u8 = film.to_u8(img, gamma=args.gamma)
        write_png(frame_path, u8)
        frames.append(u8)
        print(f"frame {i + 1}/{args.frames} -> {frame_path}", flush=True)
    if args.gif:
        try:
            from PIL import Image
        except ImportError as e:
            raise SystemExit(
                "--gif needs Pillow (PIL), which is not installed; the PNG "
                f"frames are in {args.out}"
            ) from e

        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(
            os.path.join(args.out, "turntable.gif"),
            save_all=True, append_images=imgs[1:], duration=120, loop=0,
        )
    print(f"{args.frames} frames in {time.perf_counter() - t0:.1f}s -> {args.out}")
    return 0


def cmd_invert(args) -> int:
    from gpupathtracer_tpu.grad.inverse import (
        run_camera_demo,
        run_inverse_demo,
        run_silhouette_demo,
    )

    if args.mode == "silhouette":
        result = run_silhouette_demo(steps=args.steps, out_dir=args.out, spp=args.spp)
        print(json.dumps(result))
        return 0
    if args.mode == "camera":
        result = run_camera_demo(steps=args.steps, out_dir=args.out, spp=args.spp)
        print(json.dumps(result))
        return 0
    result = run_inverse_demo(
        steps=args.steps,
        out_dir=args.out,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        width=args.size,
        height=args.size,
        spp=args.spp,
        subdivisions=args.subdivisions,
    )
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="firefly", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene config to an image file")
    pr.add_argument("scene", help="scene config (.toml/.json)")
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--spp", type=int, default=None)
    pr.add_argument("--aov", default=None, choices=["radiance", "normal", "normal_unit"])
    pr.add_argument("--gamma", type=float, default=None)
    pr.add_argument("--estimator", default=None, choices=["naive", "nee", "mis"])
    pr.add_argument("--intersector", default=None, choices=["auto", "pallas", "plucker", "brute"])
    pr.add_argument("--checkpoint", default=None, help="film checkpoint path (.npz); resumes if present")
    pr.add_argument("--chunk-spp", type=int, default=None, help="progressive chunk size")
    pr.add_argument("--metrics", default=None, help="JSONL metrics stream path")
    pr.add_argument("--profile-dir", default=None, help="jax.profiler trace output dir")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("benchmark", help="run the rays/sec benchmark")
    pb.add_argument("--scene", default=None)
    pb.add_argument("--warmup", type=int, default=1)
    pb.add_argument("--iters", type=int, default=3)
    pb.add_argument(
        "--full", action="store_true",
        help="also run fwd+bwd, the per-config suite, and kernel microbenches",
    )
    pb.set_defaults(fn=cmd_benchmark)

    pv = sub.add_parser("view", help="viewer: turntable orbit, or --live preview")
    pv.add_argument("scene")
    pv.add_argument("--out", default="turntable")
    pv.add_argument("--frames", type=int, default=12)
    pv.add_argument("--spp", type=int, default=None)
    pv.add_argument("--gamma", type=float, default=2.2)
    pv.add_argument("--gif", action="store_true")
    pv.add_argument("--live", action="store_true", help="progressive live preview")
    pv.add_argument("--http", type=int, default=None, help="serve the live page on this port")
    pv.add_argument("--chunk-spp", type=int, default=2, help="samples per refinement chunk")
    pv.add_argument("--max-spp", type=int, default=None, help="refinement cap per camera pose")
    pv.set_defaults(fn=cmd_view)

    pi = sub.add_parser("invert", help="inverse-rendering demo (config 5)")
    pi.add_argument(
        "--mode", default="albedo", choices=["albedo", "silhouette", "camera"],
        help="albedo = recover albedo+offsets (detached grads); silhouette = "
        "recover an occluder scale via edge-sampled visibility gradients; "
        "camera = recover camera pose (x, yaw) via the camera boundary term",
    )
    pi.add_argument("--steps", type=int, default=100)
    pi.add_argument("--out", default=None)
    pi.add_argument(
        "--checkpoint", default=None,
        help="train-state checkpoint path (.pkl); resumes if present",
    )
    pi.add_argument("--checkpoint-every", type=int, default=1)
    pi.add_argument("--size", type=int, default=96, help="square image size")
    pi.add_argument("--spp", type=int, default=8)
    pi.add_argument("--subdivisions", type=int, default=2)
    pi.set_defaults(fn=cmd_invert)

    p.add_argument(
        "--platform",
        default=None,
        help="force a JAX platform (e.g. cpu, cuda); default = environment's",
    )
    args = p.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    from gpupathtracer_tpu.utils.debug import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
