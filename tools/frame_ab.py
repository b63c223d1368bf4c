"""Frame-level A/B of intersectors on the config-3 workload, on the GPU.

    python tools/frame_ab.py [pallas plucker bvh ...] [--spp 4] [--trace]

Each variant renders config 3 (its mesh replaced by the icosphere, see
chip_smoke.py) at 800x800, 4 bounces, and prints one JSON line with the
median seconds per frame over 3 timed frames (block_until_ready), path
segments per second, compile time and the card's name and power limit.
With ``--trace`` one more frame per variant runs under jax.profiler (into a
temporary directory, deleted after), and the device time of that frame is
summed per operation name (top 12), with the device's busy share of the
traced window.
"""

import argparse
import collections
import dataclasses
import glob
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def device_time_by_op(trace_dir: str, top: int = 12):
    """Sum device-plane event durations per name from the newest xplane.pb.

    Returns (busy_ns, window_ns, [(name, ns), ...]): busy is the union of
    event intervals on the GPU planes, window spans first start to last end.
    """
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    data = jax.profiler.ProfileData.from_file(paths[-1])
    per_op = collections.Counter()
    intervals = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                per_op[ev.name] += ev.duration_ns
                intervals.append((ev.start_ns, ev.end_ns))
    if not intervals:
        return 0, 0, []
    intervals.sort()
    busy, cur_s, cur_e = 0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    return busy, window, per_op.most_common(top)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("variants", nargs="*", default=["pallas", "plucker"])
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--trace", action="store_true", help="profile one frame per variant")
    args = p.parse_args()

    import chip_smoke
    from gpupathtracer_tpu.render.renderer import render_frame
    from gpupathtracer_tpu.utils.config import load_scene_file
    from gpupathtracer_tpu.utils.debug import enable_compile_cache

    enable_compile_cache()
    card = chip_smoke.nvidia_smi()
    with tempfile.TemporaryDirectory() as tmp:
        toml = os.path.join(tmp, "c3.toml")
        chip_smoke.config3_sphere_toml(toml)
        scene, camera, settings = load_scene_file(toml)
    settings = dataclasses.replace(settings, spp=args.spp)
    segs = settings.width * settings.height * settings.spp * settings.bounces
    for name in args.variants:
        s = dataclasses.replace(settings, intersector=name)

        def frame(i):
            return jax.block_until_ready(render_frame(scene, camera, s, seed=jnp.uint32(i)))

        t0 = time.perf_counter()
        frame(0)
        compile_s = time.perf_counter() - t0
        ts = []
        for i in range(3):
            t0 = time.perf_counter()
            frame(100 + i)
            ts.append(time.perf_counter() - t0)
        dt = statistics.median(ts)
        row = {"variant": name, "seconds_per_frame": dt, "runs": ts,
               "segments_per_s": segs / dt, "compile_s": compile_s,
               "spp": s.spp, "bounces": s.bounces, "card": card}
        if args.trace:
            with tempfile.TemporaryDirectory() as tdir:
                jax.profiler.start_trace(tdir)
                frame(200)
                jax.profiler.stop_trace()
                busy, window, top = device_time_by_op(tdir)
            row.update(device_busy_ns=busy, device_window_ns=window,
                       busy_share=busy / window if window else None,
                       top_ops_ns=top)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
