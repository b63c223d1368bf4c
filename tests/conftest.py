"""Test env: CPU backend with 8 virtual devices (SURVEY.md §4.4).

``jax_platforms`` is pinned to the CPU after import, so the suite runs the
same on a machine with a GPU. The XLA flag must be set before the CPU
backend initializes (lazy, so conftest import time is early enough). The
Pallas intersection kernel compiles only for a GPU; here it runs through
the Pallas interpreter (``pallas_intersect.INTERPRET``).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from gpupathtracer_tpu.ops import pallas_intersect  # noqa: E402

pallas_intersect.INTERPRET = True


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
