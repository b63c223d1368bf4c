"""gpupathtracer_tpu — a differentiable Monte Carlo path tracer in JAX.

Brand-new JAX/XLA/Pallas framework with the capabilities of the reference CUDA
renderer FireflyRenderEngine/GPUPathTracer (see SURVEY.md): per-pixel ray
generation, multi-bounce ray/triangle intersection over OBJ meshes, physically
based material sampling, and image output — redesigned as a JAX program:

- SoA ``jnp`` scene arrays (world-space pretransformed triangles) instead of
  AoS device structs (reference: ``utilities.h:148-234``).
- A wavefront ``lax.scan`` bounce loop instead of a CUDA megakernel
  (reference design: ``readme.md`` "Mega Kernel method", ``kernel.cu:186-221``).
- Plücker-coordinate intersection as block products, fused into one Pallas
  kernel on the GPU, instead of per-thread scalar Möller–Trumbore loops
  (reference: ``kernel.cu:35-176``).
- Counter-based ``jax.random`` sampling instead of curand sequences
  (reference: ``utilities.h:109-128``).
- ``jax.sharding`` mesh parallelism (data/scene axes) across several GPUs
  instead of one.
- End-to-end differentiability (``jax.grad`` through the whole estimator);
  the reference has no autodiff at all.
"""

__version__ = "0.1.0"

from gpupathtracer_tpu.models.camera import Camera  # noqa: F401
from gpupathtracer_tpu.models.materials import BxdfType, MaterialTable  # noqa: F401
from gpupathtracer_tpu.models.scene import TriangleScene  # noqa: F401
