"""The scene and wavefront containers are plain registered dataclasses:
they round-trip through tree flatten/unflatten and jit, keep their static
fields out of the leaves, and are immutable with a ``replace``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracerap.ops.intersect import HitRecord
from pathtracerap.ops.plucker import bake_world_triangles
from pathtracerap.render.shade import RayState
from pathtracerap.scene.build import build_cornell_box_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _instances():
    scene = build_cornell_box_scene().to_device()
    world = bake_world_triangles(scene, tri_block=128)
    hits = HitRecord.miss(4).replace(mat_ri=jnp.full((4,), 1.5))
    state = RayState.primary(jnp.zeros((4, 3)), jnp.ones((4, 3)), 3)
    return {"SceneDevice": scene, "WorldTriangles": world,
            "HitRecord": hits, "RayState": state}


@pytest.fixture(scope="module")
def instances():
    return _instances()


@pytest.mark.parametrize("name", ["SceneDevice", "WorldTriangles", "HitRecord", "RayState"])
def test_pytree_round_trip(instances, name):
    obj = instances[name]
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is type(obj)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # through jit, leaves and static fields both survive
    out = jax.jit(lambda x: x)(obj)
    assert jax.tree_util.tree_structure(out) == treedef
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, dataclasses.fields(obj)[0].name, None)


def test_static_fields_are_not_leaves(instances):
    scene, world = instances["SceneDevice"], instances["WorldTriangles"]
    n_scene = len(jax.tree_util.tree_leaves(scene))
    assert all(hasattr(x, "shape") for x in jax.tree_util.tree_leaves(scene))
    assert scene.grid_dims == (25, 25, 25) and isinstance(scene.n_world_valid, int)
    assert world.tri_block == 128 and world.n_valid == scene.n_world_valid
    # static fields are part of the tree structure: changing one retraces
    other = world.replace(tri_block=256)
    assert (jax.tree_util.tree_structure(other)
            != jax.tree_util.tree_structure(world))
    assert n_scene == len(jax.tree_util.tree_leaves(scene.replace(
        vertex_pos=scene.vertex_pos * 2.0)))


def test_main_path_imports_no_undeclared_package():
    """Importing the main path loads nothing beyond jax, numpy and the
    standard library (flax, torch and the triton package stay unloaded)."""
    import subprocess
    import sys

    code = (
        "import sys, pathtracerap.render.wavefront, pathtracerap.diff.grad, "
        "pathtracerap.parallel, pathtracerap.pallas.trace; "
        "print(sorted(m for m in ('flax', 'torch', 'triton', 'scipy') if m in sys.modules))"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
