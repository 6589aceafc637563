"""PTAP_DEBUG mode: checkify'd invariants of the traversal kernel.

The kernel keeps the reference's explicit det == 0 mask; these tests pin
its agreement with the XLA sweep on grazing/degenerate rays, and that the
checkify wrapper accepts a healthy traversal and fires on a broken one.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pathtracerap.config import CameraConfig, RenderConfig
from pathtracerap.ops.plucker import bake_world_triangles
from pathtracerap.pallas.trace import trace_pallas
from pathtracerap.render.wavefront import Renderer
from pathtracerap.scene.build import build_cornell_box_scene

CAMERA = CameraConfig(
    position=(0.0, 0.0, 150.0),
    plane_x=(-40.0, 40.0),
    plane_y=(-30.0, 30.0),
    plane_z=100.0,
)


@pytest.fixture(scope="module")
def world():
    return jax.jit(bake_world_triangles)(build_cornell_box_scene().to_device())


def _degenerate_rays(world):
    """Rays built to stress the det==0 / grazing accept paths."""
    v0 = np.asarray(world.v0)
    e1 = np.asarray(world.e1)
    e2 = np.asarray(world.e2)
    valid = np.asarray(world.valid) > 0
    i = int(np.argmax(valid))
    a, d1, d2 = v0[i], e1[i], e2[i]
    n = np.cross(d1, d2)
    n = n / np.linalg.norm(n)
    ros, rds = [], []
    # in-plane ray (det == 0 exactly for that triangle)
    ros.append(a - 3.0 * d1)
    rds.append(d1)
    # grazing the edge (u ~ 0) from off-plane
    ros.append(a + 0.5 * d1 + 10.0 * n)
    rds.append(-n)
    # origin exactly on the surface (t ~ 0)
    ros.append(a + 0.25 * d1 + 0.25 * d2)
    rds.append(-n)
    # near-parallel: tiny normal component
    rds.append(d1 + 1e-7 * n)
    ros.append(a - 2.0 * d1 + 1e-3 * n)
    # zero-ish direction lane
    ros.append(a + 5.0 * n)
    rds.append(1e-13 * n)
    ro = np.stack(ros).astype(np.float32)
    rd = np.stack(rds).astype(np.float32)
    return jnp.asarray(ro), jnp.asarray(rd)


def test_debug_kernel_matches_fast_kernel_on_degenerates(world):
    from pathtracerap.ops.plucker import trace_mxu

    ro, rd = _degenerate_rays(world)
    fast = trace_pallas(world, ro, rd)
    ref = trace_mxu(world, ro, rd)
    # the two engines sum the side products in different orders: at an
    # origin on the surface (t ~ 0) the absolute error of t is set by the
    # coordinate magnitude (~1e2) times f32 epsilon, not by t
    np.testing.assert_allclose(
        np.asarray(fast.t), np.asarray(ref.t), rtol=1e-6, atol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(fast.mat_type), np.asarray(ref.mat_type)
    )


def test_debug_megakernel_image_matches_fast(monkeypatch):
    """PTAP_DEBUG=1 validates the kernel before rendering; the image is
    the one the kernel engine renders without it."""
    scene = build_cornell_box_scene().to_device()
    cfg = RenderConfig(resolution=(16, 8), samples_per_pixel=2, max_bounces=3,
                       camera=CAMERA, engine="pallas")
    fast = np.asarray(Renderer(scene, cfg).render())
    monkeypatch.setenv("PTAP_DEBUG", "1")
    dbg = np.asarray(Renderer(scene, cfg).render())
    np.testing.assert_allclose(fast, dbg, atol=1e-6)


def test_checked_trace_passes_on_healthy_scene(world):
    from pathtracerap.utils.debug import checked_trace
    from pathtracerap.render.camera import generate_rays

    ro, rd = generate_rays(CAMERA, (16, 8))
    rec = checked_trace(world, ro, rd)
    assert bool(jnp.any(rec.t < 1e30))


def test_checked_trace_fires_on_broken_invariant(world):
    """Marking every triangle invalid while leaving its geometry hittable
    violates the padding-rejection invariant — checkify must raise."""
    from jax.experimental.checkify import JaxRuntimeError
    from pathtracerap.utils.debug import checked_trace
    from pathtracerap.render.camera import generate_rays

    broken = world.replace(valid=jnp.zeros_like(world.valid))
    ro, rd = generate_rays(CAMERA, (16, 8))
    with pytest.raises(JaxRuntimeError):
        checked_trace(broken, ro, rd)


def test_renderer_facade_debug_env(monkeypatch):
    """PTAP_DEBUG=1 runs the checkified primary validation inside render."""
    monkeypatch.setenv("PTAP_DEBUG", "1")
    scene = build_cornell_box_scene().to_device()
    cfg = RenderConfig(resolution=(16, 8), samples_per_pixel=1, max_bounces=2,
                       camera=CAMERA, engine="pallas")
    img = np.asarray(Renderer(scene, cfg).render())
    assert np.all(np.isfinite(img))
