"""Film: sample accumulation and image conversion.

Replaces the reference's write-once u8 PBO (kernel.cu:214, 340) with a
float32 (sum, count) accumulator — the representation that makes sample-exact
checkpoint/resume (utils/checkpoint.py) and distributed tile merging
(parallel/) trivial: both are adds.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.core import struct


@struct.dataclass
class Film:
    """Accumulated radiance sums and per-pixel sample counts."""

    radiance_sum: jnp.ndarray  # (H, W, 3) float32
    sample_count: jnp.ndarray  # () or (H, W) float32

    @classmethod
    def zeros(cls, height: int, width: int) -> "Film":
        return cls(
            radiance_sum=jnp.zeros((height, width, 3), jnp.float32),
            sample_count=jnp.zeros((), jnp.float32),
        )

    def add_samples(self, radiance_hw3: jnp.ndarray, count: float = 1.0) -> "Film":
        return Film(
            radiance_sum=self.radiance_sum + radiance_hw3,
            sample_count=self.sample_count + count,
        )

    def to_image(self) -> jnp.ndarray:
        """Mean radiance (H, W, 3) float32."""
        return self.radiance_sum / jnp.maximum(self.sample_count, 1.0)


def to_u8(image: jnp.ndarray | np.ndarray, gamma: float | None = None) -> np.ndarray:
    """float radiance → u8, matching the reference's ×255 cast (kernel.cu:214).

    The reference truncation-casts ``color * 255`` into uchar3 with no clamp
    (overflow for values > 1, SURVEY.md §2.3.1); we clamp to [0, 255] — the
    intended behavior — and optionally gamma-encode first.
    """
    img = np.asarray(image, np.float32)
    if gamma:
        img = np.power(np.maximum(img, 0.0), 1.0 / gamma)
    return np.clip(img * 255.0, 0.0, 255.0).astype(np.uint8)
