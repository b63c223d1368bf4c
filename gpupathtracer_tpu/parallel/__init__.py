"""Multi-chip / multi-host parallelism over a jax.sharding.Mesh.

The reference is strictly single-GPU (SURVEY.md §2.4); everything here is a
new first-class component, designed around XLA collectives (NCCL on GPUs):

- ``mesh.py``: device mesh with ('data', 'scene') axes — pixels/samples
  shard over 'data' (DP/SP analogue), scene primitive blocks shard over
  'scene' (TP analogue, "scene-sharded intersection").
- ``render.py``: shard_map renderer — per-device pixel slices with
  layout-invariant sample keys (bit-identical to single-chip), local
  intersection against the device's scene shard, hit resolution by
  all-gather-argmin over the 'scene' axis.
- ``multihost.py``: jax.distributed init + framebuffer assembly helpers.
"""
