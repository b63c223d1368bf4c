"""Pinhole camera with the reference renderer's exact ray-generation math.

Reproduces ``Camera`` (reference ``utilities.h:269-427``) and the primary-ray
construction in ``generateRays`` (``kernel.cu:197-205``):

    Px = (x / screenWidth) * 2 - 1          # NOTE: no half-pixel offset
    Py = 1 - (y / screenHeight) * 2
    wLookAtPoint = invView @ invProj @ (vec4(Px, Py, 1, 1) * farClip)
    dir = normalize(wLookAtPoint.xyz - cameraPos)   # NOTE: no w divide

The missing half-pixel offset and missing perspective divide are reference
behavior; both are reproduced exactly when ``jitter`` offsets are zero, and
sub-pixel jitter generalizes the same formula for spp > 1 antialiasing.

The camera is a pytree whose float leaves (position, yaw, pitch, fov, ...)
are differentiable — dL/d(camera) flows through ray generation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpupathtracer_tpu.core import mat4, struct


@struct.dataclass
class Camera:
    position: jnp.ndarray  # (3,)
    yaw: jnp.ndarray  # degrees; reference default -90 (kernel.cu:321)
    pitch: jnp.ndarray  # degrees
    world_up: jnp.ndarray  # (3,)
    fov_deg: jnp.ndarray  # full vertical fov in degrees (kernel.cu:315 -> 70)
    near_clip: jnp.ndarray
    far_clip: jnp.ndarray
    width: int = struct.field(pytree_node=False, default=800)
    height: int = struct.field(pytree_node=False, default=800)

    @classmethod
    def create(
        cls,
        position=(0.0, 0.0, 15.0),
        yaw=-90.0,
        pitch=0.0,
        world_up=(0.0, 1.0, 0.0),
        fov_deg=70.0,
        near_clip=0.1,
        far_clip=1000.0,
        width=800,
        height=800,
    ) -> "Camera":
        """Defaults mirror the reference main() camera setup (kernel.cu:311-322)."""
        f32 = lambda x: jnp.asarray(x, jnp.float32)
        return cls(
            position=f32(position),
            yaw=f32(yaw),
            pitch=f32(pitch),
            world_up=f32(world_up),
            fov_deg=f32(fov_deg),
            near_clip=f32(near_clip),
            far_clip=f32(far_clip),
            width=int(width),
            height=int(height),
        )


def camera_basis(cam: Camera):
    """forward/right/up from yaw/pitch — reference UpdateBasisAxis (utilities.h:407-418)."""
    yaw = jnp.deg2rad(cam.yaw)
    pitch = jnp.deg2rad(cam.pitch)
    front = jnp.stack(
        [
            jnp.cos(yaw) * jnp.cos(pitch),
            jnp.sin(pitch),
            jnp.sin(yaw) * jnp.cos(pitch),
        ]
    )
    forward = mat4.normalize(front)
    right = mat4.normalize(jnp.cross(forward, cam.world_up))
    up = mat4.normalize(jnp.cross(right, forward))
    return forward, right, up


def view_matrix(cam: Camera) -> jnp.ndarray:
    """lookAtRH(position, position + forward, up) — utilities.h:299-302."""
    forward, _, up = camera_basis(cam)
    return mat4.look_at_rh(cam.position, cam.position + forward, up)


def projection_matrix(cam: Camera) -> jnp.ndarray:
    """perspectiveFovRH(radians(fov), W, H, near, far) — utilities.h:309-312."""
    return mat4.perspective_fov_rh(
        jnp.deg2rad(cam.fov_deg), float(cam.width), float(cam.height), cam.near_clip, cam.far_clip
    )


def generate_rays(cam: Camera, jitter_uv: jnp.ndarray | None = None):
    """Primary rays for the full pixel grid, row-major pixel order.

    Returns ``(origins, directions)`` each of shape (H*W, 3). With
    ``jitter_uv=None`` this bit-matches the reference's per-pixel rays
    (kernel.cu:197-205). ``jitter_uv`` of shape (H*W, 2) in [0,1) adds
    sub-pixel offsets for antialiasing (spp > 1).
    """
    pixel_idx = jnp.arange(cam.height * cam.width, dtype=jnp.uint32)
    return generate_rays_for_pixels(cam, pixel_idx, jitter_uv)


def generate_rays_for_pixels(cam: Camera, pixel_idx: jnp.ndarray, jitter_uv=None):
    """Primary rays for arbitrary row-major pixel ids (R,) — the sharded
    renderer passes each device its own pixel slice."""
    w, h = cam.width, cam.height
    inv_view = mat4.inverse(view_matrix(cam))
    inv_proj = mat4.inverse(projection_matrix(cam))

    xs = (pixel_idx % jnp.uint32(w)).astype(jnp.float32)
    ys = (pixel_idx // jnp.uint32(w)).astype(jnp.float32)
    if jitter_uv is not None:
        xs = xs + jitter_uv[:, 0]
        ys = ys + jitter_uv[:, 1]

    px = (xs / jnp.float32(w)) * 2.0 - 1.0
    py = 1.0 - (ys / jnp.float32(h)) * 2.0

    # vec4(Px, Py, 1, 1) * farClip, then invProj, then invView; take .xyz with
    # NO perspective divide (glm vec3(vec4) just drops w) — kernel.cu:203.
    clip = jnp.stack([px, py, jnp.ones_like(px), jnp.ones_like(px)], axis=-1) * cam.far_clip
    # Exact f32 products: clip coordinates are scaled by far_clip (1000), so
    # TF32 rounding would move ray directions visibly.
    hi = jax.lax.Precision.HIGHEST
    m = jnp.matmul(inv_view, inv_proj, precision=hi)  # (4,4)
    look_at = jnp.matmul(clip, m.T, precision=hi)  # (R,4)
    dirs = mat4.normalize(look_at[:, :3] - cam.position[None, :])
    origins = jnp.broadcast_to(cam.position[None, :], dirs.shape)
    return origins, dirs


def mouse_move(cam: Camera, dx: float, dy: float, constrain_pitch: bool = True) -> Camera:
    """Mouse-look — reference ProcessMouseMovement (utilities.h:385-404):
    yaw += dx·sensitivity, pitch += dy·sensitivity, pitch clamped to ±89°."""
    sensitivity = 0.2  # m_cameraMouseSensitivity (utilities.h:288)
    yaw = cam.yaw + dx * sensitivity
    pitch = cam.pitch + dy * sensitivity
    if constrain_pitch:
        pitch = jnp.clip(pitch, -89.0, 89.0)
    return cam.replace(yaw=yaw, pitch=pitch)


def move(cam: Camera, direction: int) -> Camera:
    """Keyboard-style camera controls — reference ProcessKeyboard (utilities.h:343-382).

    0..5: forward/backward/left/right/up/down by movement velocity;
    6/7: yaw -/+ 0.5 deg; 8/9: pitch +/- 0.5 deg; 10: reset (utilities.h:420-426).
    """
    velocity = 0.2  # m_cameraMouseSensitivity default (utilities.h:288)
    forward, right, up = camera_basis(cam)
    pos, yaw, pitch = cam.position, cam.yaw, cam.pitch
    if direction == 0:
        pos = pos + forward * velocity
    elif direction == 1:
        pos = pos - forward * velocity
    elif direction == 2:
        pos = pos - right * velocity
    elif direction == 3:
        pos = pos + right * velocity
    elif direction == 4:
        pos = pos + up * velocity
    elif direction == 5:
        pos = pos - up * velocity
    elif direction == 6:
        yaw = yaw - 0.5
    elif direction == 7:
        yaw = yaw + 0.5
    elif direction == 8:
        pitch = pitch + 0.5
    elif direction == 9:
        pitch = pitch - 0.5
    elif direction == 10:
        return cam.replace(
            position=jnp.asarray([0.0, 0.0, 15.0], jnp.float32),
            yaw=jnp.asarray(-90.0, jnp.float32),
            pitch=jnp.asarray(0.0, jnp.float32),
        )
    return cam.replace(position=pos, yaw=yaw, pitch=pitch)
