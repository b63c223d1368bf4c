"""float32 products where exactness is part of the contract are pinned to
HIGHEST at their call sites (a GPU would otherwise run them in TF32): read
each site's dot precision off its jaxpr."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.core import mat4
from gpupathtracer_tpu.grad import edges
from gpupathtracer_tpu.models.camera import Camera, generate_rays
from gpupathtracer_tpu.models.scene import build_scene, sphere_spec
from gpupathtracer_tpu.ops import plucker

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
CAM = Camera.create(width=8, height=8)


def _dot_precisions(fn, *args):
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                inner = getattr(v, "jaxpr", v)
                if hasattr(inner, "eqns"):
                    walk(inner)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def _plucker_case():
    scene = build_scene([sphere_spec(subdivisions=1)], [{"type": "diffuse"}], pad_to_multiple=16)
    packed = plucker.pack_triangles(scene, tri_block=16)
    o = jnp.zeros((8, 3)) + jnp.asarray([0.0, 0.0, 5.0])
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (8, 1))
    return lambda a, b: plucker.intersect_plucker_jnp(a, b, packed).t, (o, d)


CASES = {
    "plucker_scan": _plucker_case,
    "camera_rays": lambda: (lambda c: generate_rays(c)[1], (CAM,)),
    "mat4_trs": lambda: (
        lambda p, r, s: mat4.trs(p, r, s),
        (jnp.ones(3), jnp.asarray([10.0, 20.0, 30.0]), jnp.ones(3)),
    ),
    "mat4_look_at": lambda: (
        lambda e: mat4.look_at_rh(e, jnp.zeros(3), jnp.asarray([0.0, 1.0, 0.0])),
        (jnp.asarray([1.0, 2.0, 3.0]),),
    ),
    "mat4_transform_points": lambda: (
        lambda m, p: mat4.transform_points(m, p), (jnp.eye(4), jnp.ones((5, 3)))
    ),
    "mat4_transform_vectors": lambda: (
        lambda m, v: mat4.transform_vectors(m, v), (jnp.eye(4), jnp.ones((5, 3)))
    ),
    "silhouette_projection": lambda: (lambda p: edges.screen_xy(CAM, p), (jnp.ones((4, 3)),)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_call_site_pins_highest(name):
    fn, args = CASES[name]()
    precisions = _dot_precisions(fn, *args)
    assert precisions, f"{name}: no dot_general traced"
    assert all(p == HIGHEST for p in precisions), (name, precisions)


def test_no_global_matmul_precision_flag():
    """Pinned per call site, not by a process-wide default."""
    assert jax.config.jax_default_matmul_precision is None


def test_pinned_camera_rays_match_float64():
    """The f32 primary rays agree with a float64 evaluation of the same
    reference ray-generation formula (kernel.cu:197-205) to f32 rounding;
    clip coordinates are scaled by far_clip = 1000, which is what TF32
    rounding would not survive."""
    from gpupathtracer_tpu.models.camera import projection_matrix, view_matrix

    _, d = generate_rays(CAM)
    inv = np.linalg.inv(np.asarray(view_matrix(CAM), np.float64)) @ np.linalg.inv(
        np.asarray(projection_matrix(CAM), np.float64)
    )
    idx = np.arange(CAM.width * CAM.height)
    px = (idx % CAM.width) / CAM.width * 2.0 - 1.0
    py = 1.0 - (idx // CAM.width) / CAM.height * 2.0
    clip = np.stack([px, py, np.ones_like(px), np.ones_like(px)], axis=-1) * float(CAM.far_clip)
    look = clip @ inv.T
    want = look[:, :3] - np.asarray(CAM.position, np.float64)
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_allclose(np.asarray(d, np.float64), want, atol=2e-5)
