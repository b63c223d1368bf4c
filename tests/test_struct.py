"""The in-repo dataclass pytree helper (core/struct.py) that the scene,
camera, material and packing types are built on."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from gpupathtracer_tpu.core import struct


@struct.dataclass
class _Point:
    xy: jnp.ndarray
    weight: jnp.ndarray
    label: str = struct.field(pytree_node=False, default="p")


def test_struct_fields_split_into_children_and_static():
    p = _Point(xy=jnp.ones(2), weight=jnp.float32(2.0), label="a")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2  # the static label is not a leaf
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.label == "a" and back.xy is p.xy and back.weight is p.weight
    # Static fields are part of the treedef: a different label retraces.
    q = p.replace(label="b")
    assert jax.tree_util.tree_structure(q) != treedef


def test_struct_replace_is_functional_and_frozen():
    p = _Point(xy=jnp.zeros(2), weight=jnp.float32(1.0))
    q = p.replace(weight=jnp.float32(3.0))
    assert float(p.weight) == 1.0 and float(q.weight) == 3.0
    assert q.label == "p"
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.weight = jnp.float32(5.0)


def test_struct_under_jit_and_grad():
    calls = []

    @jax.jit
    def f(p):
        calls.append(p.label)
        return jnp.sum(p.xy) * p.weight

    p = _Point(xy=jnp.asarray([1.0, 2.0]), weight=jnp.float32(2.0))
    assert float(f(p)) == 6.0
    f(p.replace(xy=jnp.asarray([3.0, 4.0])))  # same static label: no retrace
    assert calls == ["p"]
    g = jax.grad(lambda p: jnp.sum(p.xy) * p.weight)(p)
    assert isinstance(g, _Point) and g.label == "p"
    assert float(g.weight) == 3.0
