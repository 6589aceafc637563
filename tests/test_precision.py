"""Every f32 product on the device path states its precision.

Without one, a float32 ``dot_general`` may run in TF32 on the GPU (~1e-3
relative error: about one world unit at the reference scene's scale, ten
times the 0.1 spawn offset).  These tests walk the jaxprs of the bake,
the tracers, shading and the differentiable replay.
"""

import jax
import jax.numpy as jnp
import pytest

from pathtracerap.config import CameraConfig
from pathtracerap.ops.plucker import bake_world_triangles, trace_mxu
from pathtracerap.scene.build import build_cornell_box_scene

CAMERA = CameraConfig(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0),
                      plane_y=(-30.0, 30.0), plane_z=100.0)


def _sub_jaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def f32_dots(jaxpr):
    """(precision, shapes) of every f32 dot_general, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
            v.aval.dtype == jnp.float32 for v in eqn.invars
        ):
            out.append((eqn.params["precision"],
                        [tuple(v.aval.shape) for v in eqn.invars]))
        for p in eqn.params.values():
            for sub in _sub_jaxprs(p):
                out.extend(f32_dots(sub))
    return out


def _explicit(precision):
    if precision is None:
        return False
    if isinstance(precision, tuple):
        return all(p is not None and p != jax.lax.Precision.DEFAULT for p in precision)
    return precision != jax.lax.Precision.DEFAULT


@pytest.fixture(scope="module")
def scene():
    return build_cornell_box_scene().to_device()


@pytest.fixture(scope="module")
def world(scene):
    return bake_world_triangles(scene)


def _rays(n=64):
    from pathtracerap.render.camera import generate_rays

    return generate_rays(CAMERA, (n // 8, 8))


def _case(name, scene, world):
    from pathtracerap.diff.fast import trace_pallas_diff
    from pathtracerap.diff.grad import extract_params, image_loss
    from pathtracerap.ops.math import (
        transform_direction,
        transform_normal,
        transform_position,
    )
    from pathtracerap.pallas.trace import trace_pallas
    from pathtracerap.render.shade import RayState, shade

    ro, rd = _rays()
    if name == "bake":
        return jax.make_jaxpr(bake_world_triangles)(scene)
    if name == "trace_mxu":
        return jax.make_jaxpr(trace_mxu)(world, ro, rd)
    if name == "trace_pallas":
        return jax.make_jaxpr(trace_pallas)(world, ro, rd)
    if name == "shade":
        hits = trace_mxu(world, ro, rd)
        st = RayState.primary(ro, rd, 3)
        u = jnp.zeros((ro.shape[0], 4))
        return jax.make_jaxpr(lambda s, h, u: shade(s, h, u, parity=False))(st, hits, u)
    if name == "diff_replay":
        def loss(v0, mat_table):
            rec = trace_pallas_diff(world.replace(v0=v0, mat_table=mat_table), ro, rd)
            return jnp.sum(rec.t) + jnp.sum(rec.mat_color)

        return jax.make_jaxpr(jax.grad(loss, argnums=(0, 1)))(world.v0, world.mat_table)
    if name == "transforms":
        m = jnp.eye(4)
        return jax.make_jaxpr(lambda p, m: (
            transform_position(p, m), transform_direction(p, m),
            transform_normal(p, m)))(ro, m)
    if name == "train_loss":
        params = extract_params(scene, ("mat_color", "vertex_pos"))
        target = jnp.zeros((64, 3))
        return jax.make_jaxpr(jax.grad(lambda p: image_loss(
            p, scene, target, jax.random.PRNGKey(0), CAMERA, (8, 8), 1, 2,
            tile_size=64, engine="pallas", parity=False)))(params)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["bake", "trace_mxu", "trace_pallas", "shade",
                                  "diff_replay", "transforms", "train_loss"])
def test_every_f32_product_states_its_precision(scene, world, name):
    dots = f32_dots(_case(name, scene, world).jaxpr)
    if name in ("bake", "trace_mxu", "diff_replay", "transforms", "train_loss"):
        assert dots, f"{name}: expected f32 products to check"
    loose = [d for d in dots if not _explicit(d[0])]
    assert not loose, f"{name}: f32 products without a precision: {loose}"


def test_walker_finds_a_default_precision_product():
    """The walk itself: a bare f32 matmul inside a loop is reported."""
    f = lambda a: jax.lax.fori_loop(0, 2, lambda i, x: x @ a, a)
    dots = f32_dots(jax.make_jaxpr(f)(jnp.ones((4, 4))).jaxpr)
    assert dots and not _explicit(dots[0][0])
