"""Tracing / profiling hooks (SURVEY.md §5).

- ``trace(dir)``: jax.profiler trace context (TensorBoard/Perfetto capture)
  around any render; wired to the CLI's ``--profile-dir``.
- ``scope(name)``: jax.named_scope for phase attribution (gen / intersect /
  shade / compact show up named in profiles).
- ``Timer``: wall-clock + rays/sec accounting (end timed work with
  ``jax.block_until_ready``).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(profile_dir: str | None):
    if not profile_dir:
        yield
        return
    jax.profiler.start_trace(profile_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def scope(name: str):
    return jax.named_scope(name)


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def stop(self, rays: int | None = None) -> dict:
        dt = time.perf_counter() - self.t0
        out = {"seconds": round(dt, 4)}
        if rays:
            out["rays_per_sec"] = round(rays / max(dt, 1e-9), 1)
        return out
