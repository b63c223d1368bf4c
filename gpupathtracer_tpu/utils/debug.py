"""Debug / sanitizer modes (SURVEY.md §5 race detection & sanitizers).

Races are designed out by pure-functional JAX; what remains is numeric and
indexing hygiene:

- ``debug_mode()``: enables jax_debug_nans + disables jit for step-through.
- ``checkify_render``: wraps a render callable with jax.experimental.checkify
  (NaN + out-of-bounds index checks) and returns (error, result).
- Pallas kernels run through the Pallas interpreter on CPU in the tests
  (see tests/test_plucker.py), which bounds-checks every ref access.
"""

from __future__ import annotations

import contextlib
import os

import jax


@contextlib.contextmanager
def debug_mode(disable_jit: bool = False):
    jax.config.update("jax_debug_nans", True)
    try:
        if disable_jit:
            with jax.disable_jit():
                yield
        else:
            yield
    finally:
        jax.config.update("jax_debug_nans", False)


def checkify_render(fn):
    """fn(*args) -> (error, out); raise with error.throw() if desired."""
    from jax.experimental import checkify

    checked = checkify.checkify(fn, errors=checkify.float_checks | checkify.index_checks)

    def wrapper(*args, **kwargs):
        return checked(*args, **kwargs)

    return wrapper


# Fixed, inside the checkout: the cache directory is part of the cache key,
# so a path that moves between runs never hits. Listed in .gitignore.
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads that directory itself
    and nothing is set here; otherwise the fixed in-checkout directory is.
    """
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_COMPILE_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
