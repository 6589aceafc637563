"""Golden end-to-end tests: the jitted wavefront renderer vs the scalar
oracle path tracer consuming the identical uniform stream."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pathtracerap.config import CameraConfig, RenderConfig
from pathtracerap.ops.rng import sample_uniforms
from pathtracerap.oracle.reference import render_scalar
from pathtracerap.render.camera import generate_rays
from pathtracerap.render.wavefront import Renderer, render_sample
from pathtracerap.scene.build import build_cornell_box_scene

RES = (48, 32)
CAMERA = CameraConfig(
    position=(0.0, 0.0, 150.0),
    plane_x=(-40.0, 40.0),
    plane_y=(-30.0, 30.0),
    plane_z=100.0,
)


@pytest.fixture(scope="module")
def cornell():
    return build_cornell_box_scene()


@pytest.fixture(scope="module")
def cornell_dev(cornell):
    return cornell.to_device()


@pytest.mark.parametrize("engine", ["parity", "mxu", "pallas"])
def test_single_sample_matches_oracle(cornell, cornell_dev, engine):
    max_bounces = 5
    key = jax.random.PRNGKey(7)
    ro, rd = generate_rays(CAMERA, RES)
    n = ro.shape[0]

    contrib = np.asarray(
        jax.jit(render_sample, static_argnames=("max_bounces", "engine", "parity"))(
            cornell_dev, ro, rd, key, 0, max_bounces, engine=engine, parity=True
        )
    )

    # identical uniform stream for the oracle: depth = max_bounces - b
    uniforms = np.stack(
        [np.asarray(sample_uniforms(key, 0, max_bounces - b, n)) for b in range(max_bounces)]
    )
    expect = render_scalar(cornell, np.asarray(ro), np.asarray(rd), uniforms, max_bounces)

    close = np.all(np.abs(contrib - expect) < 5e-3, axis=1)
    frac = close.mean()
    # mxu may resolve a handful of grazing hits differently from the DDA
    min_frac = 0.995 if engine == "parity" else 0.97
    assert frac >= min_frac, f"{engine}: only {frac:.3f} of pixels match oracle"
    # and matching pixels must match tightly
    np.testing.assert_allclose(contrib[close], expect[close], atol=5e-3)


def test_renderer_facade_produces_image(cornell_dev):
    cfg = RenderConfig(
        resolution=RES,
        samples_per_pixel=4,
        max_bounces=3,
        camera=CAMERA,
        engine="mxu",
    )
    img = np.asarray(Renderer(cornell_dev, cfg).render())
    assert img.shape == (RES[1], RES[0], 3)
    assert np.all(np.isfinite(img))
    assert img.max() > 0.05  # something got lit
    assert img.min() >= 0.0


def test_engines_agree_on_most_pixels(cornell_dev):
    cfg = dict(resolution=RES, samples_per_pixel=8, max_bounces=3, camera=CAMERA)
    img_a = np.asarray(Renderer(cornell_dev, RenderConfig(engine="parity", **cfg)).render())
    img_b = np.asarray(Renderer(cornell_dev, RenderConfig(engine="mxu", **cfg)).render())
    # The engines intentionally differ where the reference's DDA early-exit
    # quirk returns a non-nearest hit (Renderer.cpp:326-329) and on grazing
    # epsilon ties; everywhere else identical RNG => near-identical pixels.
    diff = np.abs(img_a - img_b).max(axis=2)
    assert (diff < 1e-3).mean() > 0.95
    assert np.median(np.abs(img_a - img_b)) < 1e-4


def test_render_chunked_equals_unchunked(cornell_dev):
    base = dict(resolution=RES, max_bounces=2, camera=CAMERA, engine="mxu")
    img_a = np.asarray(
        Renderer(cornell_dev, RenderConfig(samples_per_pixel=6, **base)).render()
    )
    img_b = np.asarray(
        Renderer(
            cornell_dev, RenderConfig(samples_per_pixel=6, samples_per_chunk=2, **base)
        ).render()
    )
    np.testing.assert_allclose(img_a, img_b, atol=1e-5)
