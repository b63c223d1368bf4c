"""glm-convention 4x4 matrix math, as differentiable jnp ops.

The reference renderer builds all of its transforms with glm 0.9.9.7
(right-handed, negative-one-to-one clip depth):

- model matrix ``T * Rx * Ry * Rz * S`` with Euler angles in *degrees*
  (reference ``utilities.h:180-189``),
- ``glm::lookAtRH`` for the view matrix (``utilities.h:299-302``),
- ``glm::perspectiveFovRH`` for projection (``utilities.h:309-312``),
- normal transform ``inverse(transpose(M))`` (``kernel.cu:117``).

These helpers reproduce glm's math exactly, written in standard row-major
convention (``M @ v`` with column vector ``v``); glm stores columns, so
``M[row, col]`` here equals glm's ``m[col][row]``. Everything is float32 jnp
and differentiable (camera/object transforms are optimizable parameters in
the inverse-rendering path).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Every product here is pinned to exact f32: these transforms set the
# geometry and the camera rays that the reference-parity tests compare
# bit for bit, and a GPU would otherwise run float32 matmuls in TF32.
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


def _f32(x):
    return jnp.asarray(x, dtype=jnp.float32)


def identity() -> jnp.ndarray:
    return jnp.eye(4, dtype=jnp.float32)


def translate(v) -> jnp.ndarray:
    """glm::translate(mat4(1), v)."""
    v = _f32(v)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(v)


def scale(v) -> jnp.ndarray:
    """glm::scale(mat4(1), v)."""
    v = _f32(v)
    return jnp.diag(jnp.concatenate([v, jnp.ones((1,), jnp.float32)]))


def _axis_rotation(angle_rad, axis: int) -> jnp.ndarray:
    c = jnp.cos(angle_rad)
    s = jnp.sin(angle_rad)
    m = jnp.eye(4, dtype=jnp.float32)
    i, j = {0: (1, 2), 1: (2, 0), 2: (0, 1)}[axis]
    m = m.at[i, i].set(c)
    m = m.at[i, j].set(-s)
    m = m.at[j, i].set(s)
    m = m.at[j, j].set(c)
    return m


def rotate_x_deg(deg) -> jnp.ndarray:
    return _axis_rotation(jnp.deg2rad(_f32(deg)), 0)


def rotate_y_deg(deg) -> jnp.ndarray:
    return _axis_rotation(jnp.deg2rad(_f32(deg)), 1)


def rotate_z_deg(deg) -> jnp.ndarray:
    return _axis_rotation(jnp.deg2rad(_f32(deg)), 2)


def trs(position, rotation_deg, scale_v) -> jnp.ndarray:
    """Model matrix ``T * Rx * Ry * Rz * S`` (Euler degrees, glm order).

    Matches the reference Geometry constructor exactly
    (``utilities.h:180-189``): per-axis glm::rotate calls composed as
    ``rotateM = Rx; rotateM *= Ry; rotateM *= Rz`` which is ``Rx @ Ry @ Rz``.
    """
    rotation_deg = _f32(rotation_deg)
    r = _mm(_mm(rotate_x_deg(rotation_deg[0]), rotate_y_deg(rotation_deg[1])), rotate_z_deg(rotation_deg[2]))
    return _mm(_mm(translate(position), r), scale(scale_v))


def look_at_rh(eye, center, up) -> jnp.ndarray:
    """glm::lookAtRH (matrix_transform.inl)."""
    eye, center, up = _f32(eye), _f32(center), _f32(up)
    f = _normalize(center - eye)
    s = _normalize(jnp.cross(f, up))
    u = jnp.cross(s, f)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, :3].set(s)
    m = m.at[1, :3].set(u)
    m = m.at[2, :3].set(-f)
    m = m.at[0, 3].set(-jnp.dot(s, eye, precision=_HI))
    m = m.at[1, 3].set(-jnp.dot(u, eye, precision=_HI))
    m = m.at[2, 3].set(jnp.dot(f, eye, precision=_HI))
    return m


def perspective_fov_rh(fov_rad, width, height, z_near, z_far) -> jnp.ndarray:
    """glm::perspectiveFovRH with the default NEGATIVE_ONE_TO_ONE clip depth.

    glm source: h = cos(fov/2)/sin(fov/2); w = h * height / width;
    m[2][2] = -(far+near)/(far-near); m[3][2] = -2*far*near/(far-near);
    m[2][3] = -1.
    """
    fov_rad = _f32(fov_rad)
    width = _f32(width)
    height = _f32(height)
    z_near = _f32(z_near)
    z_far = _f32(z_far)
    h = jnp.cos(0.5 * fov_rad) / jnp.sin(0.5 * fov_rad)
    w = h * height / width
    m = jnp.zeros((4, 4), dtype=jnp.float32)
    m = m.at[0, 0].set(w)
    m = m.at[1, 1].set(h)
    m = m.at[2, 2].set(-(z_far + z_near) / (z_far - z_near))
    m = m.at[2, 3].set(-(2.0 * z_far * z_near) / (z_far - z_near))
    m = m.at[3, 2].set(-1.0)
    return m


def inverse(m) -> jnp.ndarray:
    return jnp.linalg.inv(_f32(m))


def normal_matrix(m) -> jnp.ndarray:
    """``inverse(transpose(M))`` — the reference's normal transform (kernel.cu:117)."""
    return jnp.linalg.inv(jnp.transpose(_f32(m)))


def transform_points(m, pts) -> jnp.ndarray:
    """Apply mat4 to points (..., 3) with w=1 (drops w, no perspective divide)."""
    pts = _f32(pts)
    return _mm(pts, jnp.transpose(m[:3, :3])) + m[:3, 3]


def transform_vectors(m, vecs) -> jnp.ndarray:
    """Apply mat4 to direction vectors (..., 3) with w=0."""
    vecs = _f32(vecs)
    return _mm(vecs, jnp.transpose(m[:3, :3]))


# NOTE: the squared guard epsilon must be a *normal* f32 (>= ~1.18e-38): XLA
# flushes subnormals to zero, so e.g. (1e-20)^2 = 1e-40 silently becomes 0
# and 0/0 = NaN on degenerate (zero-area) triangles.
_NORM_EPS_SQ = 1e-24


def _normalize(v, eps_sq: float = _NORM_EPS_SQ):
    return v / jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps_sq))


def normalize(v, axis: int = -1) -> jnp.ndarray:
    """Safe normalize: clamps INSIDE the sqrt so the VJP at the zero vector
    is 0, not NaN (sqrt'(0) = inf would otherwise poison gradients through
    padding rows / missed rays)."""
    v = _f32(v)
    n = jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=axis, keepdims=True), _NORM_EPS_SQ))
    return v / n
