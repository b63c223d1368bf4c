"""Device mesh construction: ('data', 'scene') axes.

'data' shards pixels/samples (no communication until framebuffer assembly);
'scene' shards triangle blocks for scenes that exceed per-chip HBM or to
parallelize the O(N) intersection sweep (SURVEY.md §2.4 TP row). Axis sizes
multiply to the device count. The cards of one host are joined all to all
(NVLink), so the mesh follows the algorithm and takes jax.devices() order
as it comes.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_data: int | None = None, n_scene: int = 1, devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_data is None:
        assert n % n_scene == 0, (n, n_scene)
        n_data = n // n_scene
    assert n_data * n_scene == n, f"mesh {n_data}x{n_scene} != {n} devices"
    return Mesh(np.asarray(devices).reshape(n_data, n_scene), ("data", "scene"))


def default_mesh(devices=None) -> Mesh:
    """All devices on 'data' — the right default for replicable scenes."""
    return make_mesh(n_scene=1, devices=devices)
