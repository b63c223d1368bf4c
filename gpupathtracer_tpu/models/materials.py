"""Material model: the reference's BXDF family as an SoA table.

The reference declares a tagged-union material struct with four types —
EMITTER / DIFFUSE / MIRROR / GLASS (``utilities.h:68-88``) — but implements
only emitter radiance and a half-finished diffuse sample (``utilities.h:90-139``).
This module carries the *full* capability: all four types with physically
consistent sampling (see render/integrator.py for the estimator):

- EMITTER: radiance ``emissive * intensity``, two-sided (utilities.h:96-103).
- DIFFUSE: Lambertian ``albedo/pi`` with cosine-weighted hemisphere sampling
  (the reference's warp, utilities.h:46-55, pdf cos/pi utilities.h:131-138).
- MIRROR: perfect specular reflection scaled by ``specular_color``.
- GLASS: dielectric with Schlick Fresnel reflect/refract, ``refractive_index``
  and ``transmittance_color`` (declared fields, utilities.h:85-88).

Textured albedo (beyond the reference, which stores per-vertex UVs it never
shades with — utilities.h:156-166): diffuse albedo may come from a
procedural checker or a bilinear-sampled image texture via the interpolated
hit UV (``TEX_*`` kinds, :func:`textured_albedo`). Image texels are jnp
arrays on the scene, so dL/d(texels) flows — textures are invertible too.

Parameters live in a flat SoA table indexed by material id; every float leaf
is differentiable (dL/d(albedo, emissive, intensity, ...) flows).
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.core import struct

# The factorized bilinear path (see textured_albedo) materializes a
# (R, W*3) row-interpolated intermediate; cap its width so the
# intermediate stays small. Wider textures take the flat-index gather path.
_FACTORIZED_MAX_COLS = 128  # W*3 <= 128  (textures up to 42 px wide)
_FACTORIZED_MAX_ROWS = 1024  # T*H one-hot depth bound


class BxdfType(enum.IntEnum):
    """Reference BXDFTyp enum order (utilities.h:68-75)."""

    EMITTER = 0
    DIFFUSE = 1
    MIRROR = 2
    GLASS = 3


# Albedo texture kinds (tex_kind column).
TEX_NONE = 0  # flat albedo
TEX_CHECKER = 1  # procedural checker: albedo / checker_color, checker_scale
TEX_IMAGE = 2  # bilinear image lookup: scene.textures[tex_id]


@struct.dataclass
class MaterialTable:
    """SoA material parameters; row i = material id i.

    Field set mirrors BXDF's members (utilities.h:83-88) plus the albedo
    texture columns (tex_kind/tex_id/checker_*).
    """

    type: jnp.ndarray  # (M,) int32 — BxdfType
    albedo: jnp.ndarray  # (M,3)
    specular_color: jnp.ndarray  # (M,3)
    refractive_index: jnp.ndarray  # (M,)
    emissive_color: jnp.ndarray  # (M,3)
    intensity: jnp.ndarray  # (M,)
    transmittance_color: jnp.ndarray  # (M,3)
    tex_kind: jnp.ndarray  # (M,) int32 — TEX_NONE/CHECKER/IMAGE
    tex_id: jnp.ndarray  # (M,) int32 — row into scene.textures (TEX_IMAGE)
    checker_color: jnp.ndarray  # (M,3) — the checker's second color
    checker_scale: jnp.ndarray  # (M,) — checker cells per unit UV

    @property
    def num_materials(self) -> int:
        return self.type.shape[0]


def material_table(materials: list[dict]) -> MaterialTable:
    """Build a MaterialTable from a list of dicts.

    Each dict: ``{"type": "diffuse"|"emitter"|"mirror"|"glass", "albedo": [r,g,b],
    "specular_color": ..., "refractive_index": f, "emissive_color": ...,
    "intensity": f, "transmittance_color": ...}`` — unspecified fields default
    to the reference's sentinel-free sensible values.

    Texture keys: ``"texture": "checker"`` with optional ``checker_color``
    (default inverted albedo) and ``checker_scale`` (default 8 cells/UV
    unit); ``"texture": "image"`` with ``texture_id`` = row in the scene's
    texture stack (see scene.build_scene(textures=...)).
    """
    n = len(materials)
    typ = np.zeros((n,), np.int32)
    albedo = np.zeros((n, 3), np.float32)
    specular = np.ones((n, 3), np.float32)
    ior = np.full((n,), 1.5, np.float32)
    emissive = np.zeros((n, 3), np.float32)
    intensity = np.zeros((n,), np.float32)
    transmit = np.ones((n, 3), np.float32)
    tex_kind = np.zeros((n,), np.int32)
    tex_id = np.full((n,), -1, np.int32)
    checker_color = np.zeros((n, 3), np.float32)
    checker_scale = np.zeros((n,), np.float32)
    for i, m in enumerate(materials):
        t = m["type"].upper() if isinstance(m.get("type"), str) else m.get("type", "DIFFUSE")
        typ[i] = int(BxdfType[t] if isinstance(t, str) else t)
        albedo[i] = np.asarray(m.get("albedo", (0.5, 0.5, 0.5)), np.float32)
        specular[i] = np.asarray(m.get("specular_color", (1.0, 1.0, 1.0)), np.float32)
        ior[i] = float(m.get("refractive_index", 1.5))
        emissive[i] = np.asarray(m.get("emissive_color", (0.0, 0.0, 0.0)), np.float32)
        intensity[i] = float(m.get("intensity", 0.0))
        transmit[i] = np.asarray(m.get("transmittance_color", (1.0, 1.0, 1.0)), np.float32)
        tex = m.get("texture", "none")
        if tex in ("checker", TEX_CHECKER):
            tex_kind[i] = TEX_CHECKER
            checker_color[i] = np.asarray(
                m.get("checker_color", 1.0 - albedo[i]), np.float32
            )
            checker_scale[i] = float(m.get("checker_scale", 8.0))
        elif tex in ("image", TEX_IMAGE):
            tex_kind[i] = TEX_IMAGE
            tex_id[i] = int(m.get("texture_id", 0))
        elif tex not in ("none", TEX_NONE, None):
            raise ValueError(f"unknown texture kind {tex!r}")
    return MaterialTable(
        type=jnp.asarray(typ),
        albedo=jnp.asarray(albedo),
        specular_color=jnp.asarray(specular),
        refractive_index=jnp.asarray(ior),
        emissive_color=jnp.asarray(emissive),
        intensity=jnp.asarray(intensity),
        transmittance_color=jnp.asarray(transmit),
        tex_kind=jnp.asarray(tex_kind),
        tex_id=jnp.asarray(tex_id),
        checker_color=jnp.asarray(checker_color),
        checker_scale=jnp.asarray(checker_scale),
    )


def textured_albedo(
    base: jnp.ndarray,  # (R,3) gathered flat albedo
    tex_kind: jnp.ndarray,  # (R,) int32
    tex_id: jnp.ndarray,  # (R,) int32
    checker_color: jnp.ndarray,  # (R,3)
    checker_scale: jnp.ndarray,  # (R,)
    uv: jnp.ndarray,  # (R,2) interpolated hit UV
    textures: jnp.ndarray | None,  # (T, H, W, 3) stacked image textures or None
) -> jnp.ndarray:
    """Per-ray effective diffuse albedo — dense masked select over texture
    kinds (same EP-analogue discipline as the material dispatch).

    - TEX_CHECKER: ``albedo`` / ``checker_color`` on the parity of
      ``floor(u·s) + floor(v·s)``.
    - TEX_IMAGE: bilinear lookup into ``textures[tex_id]`` with wrap
      addressing and half-texel centers; texels are differentiable (texture
      recovery flows through this lookup).

    Fully vectorized: no per-lane branching; lanes of absent kinds select
    their base albedo. UV convention: v = 0 is the image's BOTTOM row
    (OBJ/GL convention; writers flip for row-major storage).

    Two lowerings. The four taps as 1-D takes from a flattened
    ``(T*H*W, 3)`` table; or, for small textures, the whole bilinear
    FACTORIZES into two one-hot contractions — a row interpolation
    ``(R, T*H) @ (T*H, W*3)`` followed by a per-ray column combine — so
    d/d(texels) becomes the dot's transpose matmul instead of a 4-tap
    scatter-add. The factorized path is auto-selected for small texture
    stacks (W*3 <= 128, T*H <= 1024); both paths agree to float rounding
    (association order differs across the four taps). Which is faster on
    the H100 has not been measured yet.
    """
    out = base
    cu = jnp.floor(uv[:, 0] * checker_scale)
    cv = jnp.floor(uv[:, 1] * checker_scale)
    odd = jnp.mod(cu + cv, 2.0) >= 1.0
    checker = jnp.where(odd[:, None], checker_color, base)
    out = jnp.where((tex_kind == TEX_CHECKER)[:, None], checker, out)
    if textures is not None:
        t_rows, th, tw = textures.shape[0], textures.shape[1], textures.shape[2]
        tid = jnp.clip(tex_id, 0, t_rows - 1)
        # Wrap + half-texel centers; v flipped so v=0 is the bottom row.
        fu = uv[:, 0] * tw - 0.5
        fv = (1.0 - uv[:, 1]) * th - 0.5
        u0 = jnp.floor(fu)
        v0 = jnp.floor(fv)
        du = (fu - u0)[:, None]
        dv = (fv - v0)[:, None]
        x0 = jnp.mod(u0.astype(jnp.int32), tw)
        x1 = jnp.mod(x0 + 1, tw)
        y0 = jnp.mod(v0.astype(jnp.int32), th)
        y1 = jnp.mod(y0 + 1, th)
        if tw * 3 <= _FACTORIZED_MAX_COLS and t_rows * th <= _FACTORIZED_MAX_ROWS:
            # Factorized path: one-hot row interpolation then column mix.
            rows = textures.reshape(t_rows * th, tw * 3)
            r0 = tid * th + y0
            r1 = tid * th + y1
            rcols = jnp.arange(t_rows * th, dtype=jnp.int32)[None, :]
            wy = jnp.where(rcols == r0[:, None], 1.0 - dv, 0.0) + jnp.where(
                rcols == r1[:, None], dv, 0.0
            )
            rowmix = jax.lax.dot_general(
                wy, rows, (((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
            ).reshape(-1, tw, 3)
            xcols = jnp.arange(tw, dtype=jnp.int32)[None, :]
            wx = jnp.where(xcols == x0[:, None], 1.0 - du, 0.0) + jnp.where(
                xcols == x1[:, None], du, 0.0
            )
            bil = jnp.sum(rowmix * wx[:, :, None], axis=1)
        else:
            # General path: four 1-D takes from the flattened texel table.
            flat = textures.reshape(t_rows * th * tw, 3)
            b = tid * (th * tw)
            c00 = jnp.take(flat, b + y0 * tw + x0, axis=0)
            c01 = jnp.take(flat, b + y0 * tw + x1, axis=0)
            c10 = jnp.take(flat, b + y1 * tw + x0, axis=0)
            c11 = jnp.take(flat, b + y1 * tw + x1, axis=0)
            bil = (
                c00 * (1 - du) * (1 - dv)
                + c01 * du * (1 - dv)
                + c10 * (1 - du) * dv
                + c11 * du * dv
            )
        out = jnp.where((tex_kind == TEX_IMAGE)[:, None], bil, out)
    return out


def no_hit_color() -> jnp.ndarray:
    """The reference's miss color — pink (kernel.h:7-10).

    Note the committed reference path never actually writes it (misses stay at
    the cudaMemset 0 black, kernel.cu:340); we expose both behaviors via the
    render config's ``background`` field.
    """
    return jnp.asarray([1.0, 0.75, 0.79], jnp.float32)
