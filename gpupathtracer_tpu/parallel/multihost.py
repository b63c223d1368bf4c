"""Multi-host orchestration: process init and framebuffer assembly.

Single-host meshes work without any of this; on a multi-host slice call
``init_distributed()`` first (SURVEY.md §5 communication backend: XLA
collectives, which the GPU backend hands to NCCL; no hand-written MPI).
"""

from __future__ import annotations

import jax
import numpy as np


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """jax.distributed.initialize with env-based defaults; no-op if single."""
    if num_processes in (None, 1) and jax.process_count() == 1 and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def gather_image(image) -> np.ndarray:
    """Assemble a (possibly cross-host sharded) framebuffer on every host.

    For single-host arrays this is a device_get; for multi-host global
    arrays it all-gathers the addressable shards via
    multihost_utils.process_allgather.
    """
    if jax.process_count() == 1:
        return np.asarray(jax.device_get(image))
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(image, tiled=True))
