"""Differentiability tests: autodiff pixel gradients vs finite differences."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pathtracerap.config import CameraConfig
from pathtracerap.diff.grad import (
    extract_params,
    image_loss,
    make_sharded_train_step,
    make_train_step,
    render_for_params,
)
from pathtracerap.parallel.sharding import default_mesh
from pathtracerap.scene.build import build_cornell_box_scene

RES = (16, 8)
CAMERA = CameraConfig(
    position=(0.0, 0.0, 150.0),
    plane_x=(-40.0, 40.0),
    plane_y=(-30.0, 30.0),
    plane_z=100.0,
)
N_SAMPLES = 2
BOUNCES = 2


@pytest.fixture(scope="module")
def cornell_dev():
    return build_cornell_box_scene().to_device()


def _loss_fn(cornell_dev, target, key):
    def f(params):
        return image_loss(
            params, cornell_dev, target, key, CAMERA, RES, N_SAMPLES, BOUNCES,
            tile_size=256,
        )
    return f


def test_material_color_gradients_match_finite_difference(cornell_dev):
    key = jax.random.PRNGKey(0)
    params = extract_params(cornell_dev, ("mat_color",))
    target = jnp.zeros((RES[0] * RES[1], 3), jnp.float32)
    f = _loss_fn(cornell_dev, target, key)

    g = jax.jit(jax.grad(f))(params)["mat_color"]
    g = np.asarray(g)
    assert np.all(np.isfinite(g))
    assert np.abs(g).max() > 0.0

    # central finite differences on a few coordinates (same RNG => the
    # sampled path topology is frozen; FD and AD see the same estimator)
    f_jit = jax.jit(f)
    rng = np.random.default_rng(0)
    base = np.asarray(params["mat_color"])
    checked = 0
    for _ in range(6):
        i = rng.integers(0, base.shape[0])
        c = rng.integers(0, 3)
        if abs(g[i, c]) < 1e-6:
            continue
        eps = 1e-3
        p_hi = base.copy(); p_hi[i, c] += eps
        p_lo = base.copy(); p_lo[i, c] -= eps
        fd = (float(f_jit({"mat_color": jnp.asarray(p_hi)}))
              - float(f_jit({"mat_color": jnp.asarray(p_lo)}))) / (2 * eps)
        np.testing.assert_allclose(g[i, c], fd, rtol=5e-2, atol=1e-4)
        checked += 1
    assert checked >= 2


def test_color_has_no_vertex_gradient_by_design(cornell_dev):
    """Pixel color is a pure albedo product (Renderer.cpp:438 dropped the
    cosine), so under frozen hit topology its vertex gradient is exactly 0 —
    geometry gradients flow through the AOVs instead."""
    key = jax.random.PRNGKey(1)
    params = extract_params(cornell_dev, ("vertex_pos",))
    target = jnp.zeros((RES[0] * RES[1], 3), jnp.float32)

    def f(params):
        return image_loss(
            params, cornell_dev, target, key, CAMERA, RES, N_SAMPLES, BOUNCES,
            tile_size=256,
        )

    g = np.asarray(jax.jit(jax.grad(f))(params)["vertex_pos"])
    assert np.all(g == 0.0)


def test_vertex_gradients_flow_through_depth_normal_aovs(cornell_dev):
    from pathtracerap.diff.grad import geometry_loss, render_aovs

    params = extract_params(cornell_dev, ("vertex_pos",))
    # target: AOVs of a slightly shrunken scene
    shrunk = {"vertex_pos": params["vertex_pos"] * 0.97}
    td, tn, th = jax.jit(
        lambda p: render_aovs(p, cornell_dev, CAMERA, RES)
    )(shrunk)

    def f(p):
        return geometry_loss(p, cornell_dev, td, tn, CAMERA, RES)

    val, g = jax.jit(jax.value_and_grad(f))(params)
    g = np.asarray(g["vertex_pos"])
    assert np.isfinite(float(val)) and float(val) > 0.0
    assert np.all(np.isfinite(g))
    assert np.abs(g).max() > 0.0

    # finite-difference check on one influential coordinate
    f_jit = jax.jit(f)
    base = np.asarray(params["vertex_pos"])
    i, c = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 1e-2
    hi = base.copy(); hi[i, c] += eps
    lo = base.copy(); lo[i, c] -= eps
    fd = (float(f_jit({"vertex_pos": jnp.asarray(hi)}))
          - float(f_jit({"vertex_pos": jnp.asarray(lo)}))) / (2 * eps)
    np.testing.assert_allclose(g[i, c], fd, rtol=5e-2, atol=1e-5)


def test_train_step_reduces_loss(cornell_dev):
    key = jax.random.PRNGKey(2)
    params = extract_params(cornell_dev, ("mat_color",))
    # target: the render with darkened materials
    dark = {"mat_color": params["mat_color"] * 0.5}
    target = render_for_params(
        dark, cornell_dev, key, CAMERA, RES, N_SAMPLES, BOUNCES, tile_size=256
    )
    step = make_train_step(
        cornell_dev, CAMERA, RES, N_SAMPLES, BOUNCES, lr=0.2, tile_size=256
    )
    losses = []
    p = params
    for _ in range(5):
        loss, p = step(p, target, key)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses


def test_sharded_train_step_matches_single_device(cornell_dev):
    key = jax.random.PRNGKey(3)
    mesh = default_mesh()
    params = extract_params(cornell_dev, ("mat_color",))
    n = RES[0] * RES[1]
    target = jnp.zeros((n, 3), jnp.float32)

    step = make_sharded_train_step(
        cornell_dev, CAMERA, RES, N_SAMPLES, BOUNCES, mesh, lr=0.1, tile_size=16
    )
    loss, new_params = step(params, target, key)
    assert np.isfinite(float(loss))
    delta = np.abs(np.asarray(new_params["mat_color"]) - np.asarray(params["mat_color"]))
    assert delta.max() > 0.0


@pytest.mark.parametrize("tile_size", [256, 8192])
def test_pallas_diff_grads_match_mxu_engine(cornell_dev, tile_size):
    """The fast differentiable path (kernel forward + frozen-argmin
    recompute backward, diff/fast.py) must produce the same loss and
    gradients as differentiating straight through the XLA sweep, with a
    render tile smaller than the image and with one that holds it all."""
    key = jax.random.PRNGKey(4)
    params = extract_params(cornell_dev, ("mat_color", "vertex_pos"))
    target = jnp.zeros((RES[0] * RES[1], 3), jnp.float32)

    def loss(params, engine):
        return image_loss(
            params, cornell_dev, target, key, CAMERA, RES, N_SAMPLES, BOUNCES,
            tile_size=tile_size, engine=engine,
        )

    l_p, g_p = jax.jit(jax.value_and_grad(lambda p: loss(p, "pallas")))(params)
    l_m, g_m = jax.jit(jax.value_and_grad(lambda p: loss(p, "mxu")))(params)
    np.testing.assert_allclose(float(l_p), float(l_m), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(g_p["mat_color"]), np.asarray(g_m["mat_color"]),
        rtol=1e-4, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(g_p["vertex_pos"]), np.asarray(g_m["vertex_pos"]),
        rtol=1e-4, atol=1e-7,
    )


def test_quality_mode_vertex_gradients_through_color(cornell_dev):
    """parity=False restores the cosine factor (Renderer.cpp:438), so the
    COLOR loss itself carries nonzero vertex gradients; FD-verify one."""
    key = jax.random.PRNGKey(5)
    params = extract_params(cornell_dev, ("vertex_pos",))
    target = jnp.zeros((RES[0] * RES[1], 3), jnp.float32)

    def f(p):
        return image_loss(
            p, cornell_dev, target, key, CAMERA, RES, N_SAMPLES, BOUNCES,
            tile_size=256, parity=False,
        )

    g = np.asarray(jax.jit(jax.grad(f))(params)["vertex_pos"])
    assert np.all(np.isfinite(g))
    assert np.abs(g).max() > 0.0

    f_jit = jax.jit(f)
    base = np.asarray(params["vertex_pos"])
    i, c = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 1e-2
    hi = base.copy(); hi[i, c] += eps
    lo = base.copy(); lo[i, c] -= eps
    fd = (float(f_jit({"vertex_pos": jnp.asarray(hi)}))
          - float(f_jit({"vertex_pos": jnp.asarray(lo)}))) / (2 * eps)
    np.testing.assert_allclose(g[i, c], fd, rtol=1e-1, atol=1e-7)


def test_sharded_step_matches_single_device_exactly(cornell_dev):
    """With matched tile sizes the sharded step's loss and updated params
    must equal the single-device step's (r1 VERDICT weak item 3/6)."""
    key = jax.random.PRNGKey(6)
    mesh = default_mesh()
    params = extract_params(cornell_dev, ("mat_color",))
    n = RES[0] * RES[1]
    target = jnp.zeros((n, 3), jnp.float32)
    tile = n // mesh.devices.size  # 16: every device = exactly one RNG tile

    sharded = make_sharded_train_step(
        cornell_dev, CAMERA, RES, N_SAMPLES, BOUNCES, mesh, lr=0.1,
        tile_size=tile,
    )
    loss_s, p_s = sharded(params, target, key)

    # single-device reference: same tile size => same per-tile RNG streams;
    # its mean-loss gradient x n == the sharded sum-loss gradient
    def sum_loss(p):
        return image_loss(
            p, cornell_dev, target, key, CAMERA, RES, N_SAMPLES, BOUNCES,
            tile_size=tile, reduce="sum",
        )

    loss_1, g_1 = jax.jit(jax.value_and_grad(sum_loss))(params)
    p_1 = params["mat_color"] - 0.1 * g_1["mat_color"]
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(p_s["mat_color"]), np.asarray(p_1), rtol=1e-5, atol=1e-7
    )


def test_overlapped_reduce_matches_single_psum(cornell_dev):
    """overlap_chunks>1 interleaves per-chunk psums with compute; the
    result must equal the single-psum step up to f32 order."""
    key = jax.random.PRNGKey(7)
    mesh = default_mesh()
    params = extract_params(cornell_dev, ("mat_color",))
    n = RES[0] * RES[1]
    target = jnp.zeros((n, 3), jnp.float32)

    s1 = make_sharded_train_step(
        cornell_dev, CAMERA, RES, N_SAMPLES, BOUNCES, mesh, lr=0.1,
        tile_size=8, overlap_chunks=1,
    )
    s2 = make_sharded_train_step(
        cornell_dev, CAMERA, RES, N_SAMPLES, BOUNCES, mesh, lr=0.1,
        tile_size=8, overlap_chunks=2,
    )
    l1, p1 = s1(params, target, key)
    l2, p2 = s2(params, target, key)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(p1["mat_color"]), np.asarray(p2["mat_color"]),
        rtol=1e-5, atol=1e-7,
    )


def test_sharded_train_step_masks_padding_rays():
    """ADVICE r4 (medium): with a ray count NOT divisible by
    n_dev*tile_size, the sharded step's tile-padding rays render real scene
    content against a zero-padded target; they must contribute ZERO loss
    and ZERO gradient.  Reference: the identical padded single-device
    computation with pad rows sliced off before the loss."""
    import numpy as np
    from jax.sharding import Mesh

    from pathtracerap.diff.grad import (
        extract_params,
        make_sharded_train_step,
        render_for_params,
    )
    from pathtracerap.render.camera import generate_rays
    from pathtracerap.scene.build import build_cornell_box_scene

    scene = build_cornell_box_scene().to_device()
    camera = CAMERA
    res = (32, 17)  # n = 544: not divisible by 8 devices * 32-ray tiles
    n = res[0] * res[1]
    n_dev = len(jax.devices())
    tile = 32
    mesh = Mesh(np.asarray(jax.devices()), ("rays",))
    step = make_sharded_train_step(
        scene, camera, res, n_samples=2, max_bounces=3, mesh=mesh,
        tile_size=tile, engine="pallas",
    )
    params = extract_params(scene, ("mat_color",))
    key = jax.random.PRNGKey(3)
    target = jnp.full((n, 3), 0.25, jnp.float32)
    loss, new_params = step(params, target, key)

    # reference: one device, same padded ray layout (=> same per-tile RNG
    # streams), pad rows dropped before the loss
    per_dev = -(-(-(-n // n_dev)) // tile) * tile
    n_pad = per_dev * n_dev
    ro, rd = generate_rays(camera, res)
    ro_p = jnp.pad(ro, ((0, n_pad - n), (0, 0)))
    rd_p = jnp.pad(rd, ((0, n_pad - n), (0, 0)), constant_values=1.0)

    def ref_loss(p):
        img = render_for_params(
            p, scene, key, camera, res, 2, 3, tile_size=tile,
            ro=ro_p, rd=rd_p, tile_base=0, engine="pallas",
        )
        return jnp.sum((img[:n] - target) ** 2)

    loss_ref, g_ref = jax.jit(jax.value_and_grad(ref_loss))(params)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(new_params["mat_color"]),
        np.asarray(params["mat_color"] - 0.05 * g_ref["mat_color"]),
        rtol=1e-4, atol=1e-6,
    )


def test_refractive_scene_gradients_match_finite_difference():
    """VERDICT r4 item 8: quality-mode REFRACTIVE/SPECULAR shading is
    differentiable — pixel-loss mat_color gradients through the glass
    scene FD-check.  (The Fresnel roulette depends on ior and the frozen
    uniforms, not on mat_color, so the estimator is smooth in the
    parameters being checked.)"""
    import os

    from pathtracerap.scene.dsl import load_scene_file

    scn = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scenes", "glass_sphere.scn",
    )
    dev = load_scene_file(scn).scene.to_device()
    from pathtracerap.config import CameraConfig

    cam = CameraConfig(position=(0.0, 0.0, 110.0), plane_x=(-45.0, 45.0),
                       plane_y=(-38.0, 30.0), plane_z=60.0)
    res = (24, 18)
    key = jax.random.PRNGKey(7)
    params = extract_params(dev, ("mat_color",))
    target = jnp.zeros((res[0] * res[1], 3), jnp.float32)

    def f(p):
        return image_loss(
            p, dev, target, key, cam, res, 2, 4, tile_size=144,
            parity=False,
        )

    g = np.asarray(jax.jit(jax.grad(f))(params)["mat_color"])
    assert np.isfinite(g).all()
    # the glass material's color must carry gradient (rays pass through it)
    assert np.abs(g).max() > 0.0

    f_jit = jax.jit(f)
    base = np.asarray(params["mat_color"])
    rng = np.random.default_rng(1)
    checked = 0
    for _ in range(8):
        i = rng.integers(0, base.shape[0])
        c = rng.integers(0, 3)
        if abs(g[i, c]) < 1e-6:
            continue
        eps = 1e-3
        p_hi = base.copy(); p_hi[i, c] += eps
        p_lo = base.copy(); p_lo[i, c] -= eps
        fd = (float(f_jit({"mat_color": jnp.asarray(p_hi)}))
              - float(f_jit({"mat_color": jnp.asarray(p_lo)}))) / (2 * eps)
        np.testing.assert_allclose(g[i, c], fd, rtol=5e-2, atol=1e-4)
        checked += 1
    assert checked >= 2
