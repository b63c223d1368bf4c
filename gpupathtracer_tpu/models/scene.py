"""Scene construction: geometry descriptions → SoA world-space triangle arrays.

The reference's scene layer is an AoS ``std::vector<Geometry>`` of tagged
structs deep-copied to the GPU with per-geometry pointer patching
(``utilities.h:141-234``, ``kernel.cu:268-298``). This design replaces
that with a two-stage compile:

1. **Host stage** (`GeometrySpec`, `SceneDef`): parse OBJ assets, record TRS
   parameters and material assignments. Plain Python/numpy; no tracing.
2. **Device stage** (`build_scene`): a pure, jit-traceable, differentiable
   function mapping (local triangle arrays, TRS params, materials) → a single
   flat `TriangleScene` pytree of world-space SoA arrays.

Pretransforming triangles to world space replaces the reference's per-ray
object-space transform (``kernel.cu:138``) — same math, done once per scene
build instead of once per ray-geometry pair. Geometry kinds:

- TRIANGLEMESH: loaded OBJ triangles (utilities.h:196-209).
- PLANE: the reference's analytic unit square (object-space normal (0,0,1),
  bounds [-0.5, 0.5]^2 — kernel.cu:8-32) compiled to two *two-sided*
  triangles whose geometric normal is +z in object space, reproducing the
  plane's both-sides-visible, never-flipped-normal semantics.
- SPHERE: unimplemented in the reference (kernel.cu:166-169 prints
  "not implemented"); here supported via icosphere tessellation so the
  primitive stream stays uniform (dense vectorization).

Differentiability: `build_scene` is traceable — dL/d(vertices, TRS, material
params) all flow; it is the root of the inverse-rendering path.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.core import mat4, struct
from gpupathtracer_tpu.models.materials import MaterialTable, material_table
from gpupathtracer_tpu.models.obj import MeshData, load_obj


@struct.dataclass
class GeometrySpec:
    """One geometry instance: local-space triangles + TRS (differentiable)."""

    vertices: jnp.ndarray  # (T, 3, 3) local space
    normals: jnp.ndarray  # (T, 3, 3) local space shading normals
    uvs: jnp.ndarray  # (T, 3, 2)
    position: jnp.ndarray  # (3,)
    rotation_deg: jnp.ndarray  # (3,) Euler degrees, glm X*Y*Z order
    scale: jnp.ndarray  # (3,)
    mat_id: int = struct.field(pytree_node=False, default=0)
    two_sided: bool = struct.field(pytree_node=False, default=False)


@struct.dataclass
class TriangleScene:
    """Flat world-space SoA triangle scene — the device-side scene format."""

    v0: jnp.ndarray  # (N, 3)
    e1: jnp.ndarray  # (N, 3) = v1 - v0
    e2: jnp.ndarray  # (N, 3) = v2 - v0
    gn: jnp.ndarray  # (N, 3) unit geometric normal = normalize(cross(e1, e2))
    gn_ref: jnp.ndarray  # (N, 3) reference-parity normal: normalMatrix @ unit
    # object-space normal, NOT re-normalized — reproducing kernel.cu:117's
    # missing normalization (SURVEY.md §2.3.1) for exact normal-AOV parity.
    n0: jnp.ndarray  # (N, 3) world shading normals (normal-matrix transformed)
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray  # (N, 2)
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    geom_id: jnp.ndarray  # (N,) int32
    mat_id: jnp.ndarray  # (N,) int32
    two_sided: jnp.ndarray  # (N,) bool
    valid: jnp.ndarray  # (N,) bool — False on padding rows
    materials: MaterialTable
    # Stacked image textures (T, H, W, 3) float32 for TEX_IMAGE materials
    # (uniform size — loaders pad/resize); None when no images are used.
    # A pytree leaf: texels are differentiable and ride along replicated in
    # the sharded render paths.
    textures: jnp.ndarray | None = None

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]


_PLANE_TRIS = np.asarray(
    [
        [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0]],
        [[-0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]],
    ],
    np.float32,
)  # CCW: cross(e1, e2) = +z = the reference plane's object normal (utilities.h:229)


def plane_spec(position, rotation_deg, scale, mat_id=0) -> GeometrySpec:
    """Reference PLANE geometry (unit square at origin, +z normal, two-sided).

    UVs map the square to [0,1]² (corner (-0.5,-0.5) → uv (0,0)) so textured
    materials work on planes; the reference's plane carries no UVs at all.
    Untextured shading never reads them (resolve_hits need_uv=False).
    """
    normals = np.broadcast_to(np.asarray([0.0, 0.0, 1.0], np.float32), (2, 3, 3))
    uvs = (_PLANE_TRIS[:, :, :2] + 0.5).astype(np.float32)
    return GeometrySpec(
        vertices=jnp.asarray(_PLANE_TRIS),
        normals=jnp.asarray(normals.copy()),
        uvs=jnp.asarray(uvs),
        position=jnp.asarray(position, jnp.float32),
        rotation_deg=jnp.asarray(rotation_deg, jnp.float32),
        scale=jnp.asarray(scale, jnp.float32),
        mat_id=mat_id,
        two_sided=True,
    )


def mesh_spec(
    mesh: MeshData | str,
    position=(0.0, 0.0, 0.0),
    rotation_deg=(0.0, 0.0, 0.0),
    scale=(1.0, 1.0, 1.0),
    mat_id: int = 0,
    two_sided: bool = False,
) -> GeometrySpec:
    """TRIANGLEMESH geometry from an OBJ path or pre-loaded MeshData."""
    if isinstance(mesh, (str,)) or hasattr(mesh, "__fspath__"):
        mesh = load_obj(mesh)
    return GeometrySpec(
        vertices=jnp.asarray(mesh.vertices),
        normals=jnp.asarray(mesh.normals),
        uvs=jnp.asarray(mesh.uvs),
        position=jnp.asarray(position, jnp.float32),
        rotation_deg=jnp.asarray(rotation_deg, jnp.float32),
        scale=jnp.asarray(scale, jnp.float32),
        mat_id=mat_id,
        two_sided=two_sided,
    )


def icosphere(subdivisions: int = 3) -> MeshData:
    """Unit icosphere triangle soup (SPHERE support the reference lacks)."""
    t = (1.0 + 5.0**0.5) / 2.0
    verts = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    for _ in range(subdivisions):
        new_faces = []
        verts_list = list(verts)
        cache: dict[tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key in cache:
                return cache[key]
            m = verts_list[a] + verts_list[b]
            m = m / np.linalg.norm(m)
            verts_list.append(m)
            cache[key] = len(verts_list) - 1
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
        verts = np.asarray(verts_list)
    v = np.asarray(verts, np.float32)
    tri = np.stack([np.stack([v[a], v[b], v[c]]) for a, b, c in faces]).astype(np.float32)
    # On a unit sphere the shading normal equals the position.
    return MeshData(vertices=tri, normals=tri.copy(), uvs=np.zeros((len(faces), 3, 2), np.float32))


def sphere_spec(
    position=(0.0, 0.0, 0.0), radius: float = 1.0, mat_id: int = 0, subdivisions: int = 3
) -> GeometrySpec:
    return mesh_spec(
        icosphere(subdivisions),
        position=position,
        scale=(radius, radius, radius),
        mat_id=mat_id,
    )


def build_scene(
    specs: Sequence[GeometrySpec],
    materials: MaterialTable | list[dict],
    pad_to_multiple: int = 512,
    textures=None,
) -> TriangleScene:
    """Compile geometry specs into one flat world-space TriangleScene.

    Pure and traceable: call under jit/grad with jnp leaves in `specs` and
    `materials` to differentiate through scene construction (vertices, TRS,
    material params). Padding rows (``valid=False``) are degenerate triangles
    (zero edges ⇒ zero determinant ⇒ never hit) so kernels need no special
    casing beyond respecting ``valid`` in index outputs.
    """
    if isinstance(materials, list):
        materials = material_table(materials)

    v0s, e1s, e2s, gns, gnrefs = [], [], [], [], []
    n0s, n1s, n2s = [], [], []
    uv0s, uv1s, uv2s = [], [], []
    geom_ids, mat_ids, two_sideds = [], [], []
    for gi, spec in enumerate(specs):
        m = mat4.trs(spec.position, spec.rotation_deg, spec.scale)
        nm = mat4.normal_matrix(m)
        world = mat4.transform_points(m, spec.vertices)  # (T,3,3)
        wn = mat4.transform_vectors(nm, spec.normals)  # normal matrix, kernel.cu:117
        wn = mat4.normalize(wn)
        v0 = world[:, 0]
        e1 = world[:, 1] - world[:, 0]
        e2 = world[:, 2] - world[:, 0]
        gn = mat4.normalize(jnp.cross(e1, e2))
        # Reference-parity normal: unit object-space geometric normal pushed
        # through inverse(transpose(M)) without re-normalization (kernel.cu:101,117).
        local_gn = mat4.normalize(
            jnp.cross(spec.vertices[:, 1] - spec.vertices[:, 0], spec.vertices[:, 2] - spec.vertices[:, 0])
        )
        gn_ref = mat4.transform_vectors(nm, local_gn)
        t = world.shape[0]
        v0s.append(v0)
        e1s.append(e1)
        e2s.append(e2)
        gns.append(gn)
        gnrefs.append(gn_ref)
        n0s.append(wn[:, 0])
        n1s.append(wn[:, 1])
        n2s.append(wn[:, 2])
        uv0s.append(spec.uvs[:, 0])
        uv1s.append(spec.uvs[:, 1])
        uv2s.append(spec.uvs[:, 2])
        geom_ids.append(jnp.full((t,), gi, jnp.int32))
        mat_ids.append(jnp.full((t,), spec.mat_id, jnp.int32))
        two_sideds.append(jnp.full((t,), spec.two_sided, jnp.bool_))

    cat = lambda xs: jnp.concatenate(xs, axis=0)
    v0, e1, e2, gn, gn_ref = cat(v0s), cat(e1s), cat(e2s), cat(gns), cat(gnrefs)
    n0, n1, n2 = cat(n0s), cat(n1s), cat(n2s)
    uv0, uv1, uv2 = cat(uv0s), cat(uv1s), cat(uv2s)
    geom_id, mat_id, two_sided = cat(geom_ids), cat(mat_ids), cat(two_sideds)
    n = v0.shape[0]
    valid = jnp.ones((n,), jnp.bool_)

    if pad_to_multiple > 1:
        target = -(-n // pad_to_multiple) * pad_to_multiple
        pad = target - n
        if pad:
            pad3 = jnp.zeros((pad, 3), jnp.float32)
            pad2 = jnp.zeros((pad, 2), jnp.float32)
            padi = jnp.zeros((pad,), jnp.int32)
            padb = jnp.zeros((pad,), jnp.bool_)
            v0 = jnp.concatenate([v0, pad3])
            e1 = jnp.concatenate([e1, pad3])
            e2 = jnp.concatenate([e2, pad3])
            gn = jnp.concatenate([gn, pad3])
            gn_ref = jnp.concatenate([gn_ref, pad3])
            n0 = jnp.concatenate([n0, pad3])
            n1 = jnp.concatenate([n1, pad3])
            n2 = jnp.concatenate([n2, pad3])
            uv0 = jnp.concatenate([uv0, pad2])
            uv1 = jnp.concatenate([uv1, pad2])
            uv2 = jnp.concatenate([uv2, pad2])
            geom_id = jnp.concatenate([geom_id, padi])
            mat_id = jnp.concatenate([mat_id, padi])
            two_sided = jnp.concatenate([two_sided, padb])
            valid = jnp.concatenate([valid, padb])

    if textures is not None:
        textures = jnp.asarray(textures, jnp.float32)
        assert textures.ndim == 4 and textures.shape[-1] == 3, textures.shape
    return TriangleScene(
        v0=v0, e1=e1, e2=e2, gn=gn, gn_ref=gn_ref,
        n0=n0, n1=n1, n2=n2,
        uv0=uv0, uv1=uv1, uv2=uv2,
        geom_id=geom_id, mat_id=mat_id,
        two_sided=two_sided, valid=valid,
        materials=materials,
        textures=textures,
    )


def reference_scene(scene_resources: str = "/root/reference/sceneResources") -> tuple[list[GeometrySpec], list[dict]]:
    """The reference main()'s hardcoded scene (kernel.cu:228-259).

    rocketman.obj rotated (0, 90, 180) + four unit planes scaled 5x at
    z=±2.5 and y=±2.5, all sharing one red diffuse material
    (kernel.cu:246-251; the white emitter at kernel.cu:241-244 is dead code).
    We additionally wire the emitter to the +z plane so the *intended*
    Cornell-style light actually exists — callers wanting strict parity can
    pass mat_id=0 everywhere.
    """
    import os

    mesh = mesh_spec(
        os.path.join(scene_resources, "rocketman.obj"),
        rotation_deg=(0.0, 90.0, 180.0),
        mat_id=0,
    )
    specs = [
        mesh,
        plane_spec((0.0, 0.0, 2.5), (0.0, 0.0, 0.0), (5.0, 5.0, 5.0), mat_id=1),
        plane_spec((0.0, 0.0, -2.5), (0.0, 0.0, 0.0), (5.0, 5.0, 5.0), mat_id=0),
        plane_spec((0.0, -2.5, 0.0), (90.0, 0.0, 0.0), (5.0, 5.0, 5.0), mat_id=0),
        plane_spec((0.0, 2.5, 0.0), (90.0, 0.0, 0.0), (5.0, 5.0, 5.0), mat_id=0),
    ]
    materials = [
        {"type": "diffuse", "albedo": (1.0, 0.0, 0.0)},  # kernel.cu:237-239
        {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},  # kernel.cu:241-244
    ]
    return specs, materials
