"""Small meshes built in code for the tests (no asset files needed).

``triangle_mesh`` is the reference's triangle.obj: one CCW triangle
(0,0,0), (1,0,0), (0,1,0) with a synthesized +z normal and zero UVs — what
models/obj.py loads from that file. ``cube_mesh`` is a closed 12-triangle
cube over [-1, 1]³ with outward (CCW) winding and welded corners.
"""

import numpy as np

from gpupathtracer_tpu.models.obj import MeshData


def _mesh(tris: np.ndarray) -> MeshData:
    tris = np.asarray(tris, np.float32)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return MeshData(
        vertices=tris,
        normals=np.repeat(n[:, None, :], 3, axis=1).astype(np.float32),
        uvs=np.zeros((tris.shape[0], 3, 2), np.float32),
    )


def triangle_mesh() -> MeshData:
    return _mesh([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]])


def cube_mesh() -> MeshData:
    c = np.asarray(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32
    )  # corner index = 4·(x>0) + 2·(y>0) + (z>0)
    quads = [  # each face CCW seen from outside
        (0, 1, 3, 2),  # x = -1
        (4, 6, 7, 5),  # x = +1
        (0, 4, 5, 1),  # y = -1
        (2, 3, 7, 6),  # y = +1
        (0, 2, 6, 4),  # z = -1
        (1, 5, 7, 3),  # z = +1
    ]
    tris = []
    for a, b, cc, d in quads:
        tris += [[c[a], c[b], c[cc]], [c[a], c[cc], c[d]]]
    return _mesh(tris)
