"""The Pallas intersection kernel (ops/pallas_intersect.py) through the
Pallas interpreter on CPU: closest-hit and any-hit modes against the
Möller–Trumbore oracle, its tile/block shapes and padding, the alive mask,
and how an intersector is chosen on a machine without a GPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.models.obj import MeshData
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.ops import pallas_intersect
from gpupathtracer_tpu.ops.intersect import intersect_brute
from gpupathtracer_tpu.ops.pallas_intersect import (
    intersect_pallas,
    intersect_pallas_occluded,
    pack_scene,
)
from gpupathtracer_tpu.render.integrator import IntegratorOptions, resolved_intersector


def random_scene(seed=0, pad=128, n_one_sided=150, n_two_sided=50, rays=800):
    rng = np.random.default_rng(seed)

    def mk(n, s):
        t = rng.normal(size=(n, 3, 3)).astype(np.float32) * s
        return MeshData(
            vertices=t,
            normals=np.zeros((n, 3, 3), np.float32),
            uvs=np.zeros((n, 3, 2), np.float32),
        )

    scene = build_scene(
        [
            mesh_spec(mk(n_one_sided, 2)),
            mesh_spec(mk(n_two_sided, 2), two_sided=True),
            plane_spec((0, 0, 0), (10, 20, 0), (3, 3, 3)),
        ],
        [{"type": "diffuse"}],
        pad_to_multiple=pad,
    )
    o = jnp.asarray(rng.normal(size=(rays, 3)) * 4, jnp.float32)
    draw = rng.normal(size=(rays, 3)).astype(np.float32)
    d = jnp.asarray(draw / np.linalg.norm(draw, axis=1, keepdims=True))
    return scene, o, d


def test_occlusion_kernel_matches_thresholded_oracle():
    """occluded(o, d, max_t) ⇔ closest accepted hit has t < max_t — the
    exact predicate the NEE shadow path relies on (integrator
    make_occlusion_fn's two implementations must agree)."""
    scene, o, d = random_scene(seed=7)
    packed = pack_scene(scene, tri_block=128)
    h = intersect_brute(o, d, scene, tri_block=128)
    t_ref = np.asarray(h.t)
    hit_ref = np.asarray(h.hit)
    rng = np.random.default_rng(1)

    # Cutoffs straddling the true hit distance: some before (unoccluded),
    # some after (occluded), plus misses with finite cutoffs.
    scale = rng.uniform(0.3, 2.0, size=t_ref.shape).astype(np.float32)
    t_finite = np.where(hit_ref, t_ref, 1.0)  # miss lanes carry t = BIG; avoid overflow
    max_t = jnp.asarray(
        np.where(hit_ref, t_finite * scale, rng.uniform(0.5, 5.0, t_ref.shape)), jnp.float32
    )

    occ = np.asarray(
        intersect_pallas_occluded(o, d, max_t, packed, ray_tile=256, interpret=True)
    )
    expect = hit_ref & (t_ref < np.asarray(max_t))
    np.testing.assert_array_equal(occ, expect)
    # The cutoffs must actually exercise both outcomes.
    assert expect.sum() > 50 and (~expect).sum() > 50


def test_occlusion_kernel_dead_lanes_unoccluded():
    """max_t = 0 marks parked/dead lanes: they must report unoccluded and
    must not stop the early-exit loop for live lanes."""
    scene, o, d = random_scene(seed=8)
    packed = pack_scene(scene, tri_block=128)
    h = intersect_brute(o, d, scene, tri_block=128)
    live = np.zeros(o.shape[0], bool)
    live[::3] = True
    max_t = jnp.asarray(np.where(live, 1e6, 0.0), jnp.float32)
    occ = np.asarray(
        intersect_pallas_occluded(o, d, max_t, packed, ray_tile=256, interpret=True)
    )
    expect = np.asarray(h.hit) & live
    np.testing.assert_array_equal(occ, expect)
    assert not occ[~live].any()


@pytest.mark.parametrize(
    "ray_tile,tri_block,rays",
    [(16, 16, 800), (32, 64, 777), (64, 32, 513), (128, 128, 1000)],
)
def test_kernel_shapes_match_oracle(ray_tile, tri_block, rays):
    """Every tile/block pair, including ray counts that are not a multiple
    of the tile (padded lanes are dead): >99.9% triangle agreement with the
    oracle, t equal to 1e-4 where the winner agrees."""
    scene, o, d = random_scene(seed=9, rays=rays)
    packed = pack_scene(scene, tri_block=tri_block)
    h = intersect_pallas(o, d, packed, ray_tile=ray_tile, interpret=True)
    h_mt = intersect_brute(o, d, scene, tri_block=128)
    assert h.t.shape == (rays,) and h.tri.shape == (rays,)
    agree = np.asarray(h.tri) == np.asarray(h_mt.tri)
    assert agree.mean() > 0.999
    same = agree & np.asarray(h_mt.hit)
    np.testing.assert_allclose(
        np.asarray(h.t)[same], np.asarray(h_mt.t)[same], rtol=1e-4, atol=1e-4
    )


def test_pack_layout_and_blocks():
    """The pack is (nb, 5, K, tb): one (K, tb) test matrix per decision
    scalar, so the kernel loads power-of-two slices; rows are padded to a
    whole block and two-sided rows appear twice in tri_map."""
    from gpupathtracer_tpu.ops.plucker import K, NSCALARS

    scene, _, _ = random_scene(seed=10)
    packed = pack_scene(scene, tri_block=32)
    valid = np.asarray(scene.valid)
    rows = int(valid.sum() + (np.asarray(scene.two_sided) & valid).sum())
    nb = -(-rows // 32)
    assert packed.w.shape == (nb, NSCALARS, K, 32)
    assert packed.tri_map.shape == (nb * 32,)
    assert packed.box_lo.shape == (nb, 3) and packed.block_live.shape == (nb,)
    assert packed.tri_block == 32


def test_alive_mask_dead_lanes_report_no_hit():
    """Dead lanes (alive=False) are left out of the tile frustums and report
    no hit; live lanes equal the unmasked call exactly."""
    scene, o, d = random_scene(seed=11)
    packed = pack_scene(scene, tri_block=64)
    alive = jnp.asarray(np.arange(o.shape[0]) % 3 != 0)
    h_all = intersect_pallas(o, d, packed, ray_tile=32, interpret=True)
    h = intersect_pallas(o, d, packed, ray_tile=32, interpret=True, alive=alive)
    a = np.asarray(alive)
    np.testing.assert_array_equal(np.asarray(h.tri)[a], np.asarray(h_all.tri)[a])
    np.testing.assert_array_equal(np.asarray(h.t)[a], np.asarray(h_all.t)[a])
    assert not np.asarray(h.hit)[~a].any()
    assert (np.asarray(h.tri)[~a] == -1).all()


def test_kernel_products_are_exact_f32():
    """The kernel's decision products ask for exact float32 (the GPU would
    otherwise run them in TF32): read the dot precision off its jaxpr."""
    scene, o, d = random_scene(seed=12, rays=64)
    packed = pack_scene(scene, tri_block=32)
    jaxpr = jax.make_jaxpr(
        lambda a, b: intersect_pallas(a, b, packed, ray_tile=32, interpret=True).t
    )(o, d)
    precisions = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                precisions.append(eqn.params["precision"])
            for v in eqn.params.values():
                inner = getattr(v, "jaxpr", v)
                if hasattr(inner, "eqns"):
                    walk(inner)

    walk(jaxpr.jaxpr)
    assert len(precisions) == 5  # s0, s1, s2, D, num
    assert all(p == jax.lax.DotAlgorithmPreset.F32_F32_F32 for p in precisions)


def test_intersector_selection_without_gpu(monkeypatch):
    """On a machine without a GPU: "auto" is the XLA Plücker scan, and an
    explicit "pallas" is an error unless the tests opted in to the
    interpreter; the kernel itself refuses to compile."""
    assert not pallas_intersect.kernel_available()
    opts = IntegratorOptions()
    assert resolved_intersector(opts) == "plucker"
    for which in ("plucker", "brute", "bvh"):
        assert resolved_intersector(dataclasses.replace(opts, intersector=which)) == which
    pallas = dataclasses.replace(opts, intersector="pallas")
    assert resolved_intersector(pallas) == "pallas"  # INTERPRET is on in the tests
    monkeypatch.setattr(pallas_intersect, "INTERPRET", False)
    with pytest.raises(ValueError, match="needs a GPU"):
        resolved_intersector(pallas)
    scene, o, d = random_scene(seed=13, rays=32)
    with pytest.raises(RuntimeError, match="compiles only for a GPU"):
        intersect_pallas(o, d, pack_scene(scene, tri_block=32), ray_tile=32)


def test_intersector_auto_picks_kernel_on_gpu(monkeypatch):
    """Where the kernel's route compiles, "auto" resolves to it."""
    monkeypatch.setattr(pallas_intersect, "kernel_available", lambda: True)
    assert resolved_intersector(IntegratorOptions()) == "pallas"
    opts = IntegratorOptions(intersector="plucker")
    assert resolved_intersector(opts) == "plucker"
