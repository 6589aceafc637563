"""The kernel engine (``pallas``) vs the XLA sweep (``mxu``), end to end.

Both engines consume the same uniform stream, so at matched configs the
rendered images must agree per pixel (the kernel runs in the Pallas
interpreter here; ``chip_smoke.py`` repeats the comparison on the GPU).
"""

import numpy as np
import pytest

from pathtracerap.config import CameraConfig, RenderConfig
from pathtracerap.render.wavefront import Renderer
from pathtracerap.scene.build import build_cornell_box_scene


@pytest.fixture(scope="module")
def scene():
    return build_cornell_box_scene().to_device()


CAMERA = CameraConfig(
    position=(0.0, 0.0, 150.0),
    plane_x=(-40.0, 40.0),
    plane_y=(-30.0, 30.0),
    plane_z=100.0,
)
JITTER_CAMERA = CameraConfig(
    position=CAMERA.position,
    plane_x=CAMERA.plane_x,
    plane_y=CAMERA.plane_y,
    plane_z=CAMERA.plane_z,
    jitter=True,
)


def _render(scene, engine, **over):
    cfg = dict(
        resolution=(16, 8), samples_per_pixel=4, max_bounces=3, camera=CAMERA
    )
    cfg.update(over)
    return np.asarray(Renderer(scene, RenderConfig(engine=engine, **cfg)).render())


@pytest.mark.parametrize(
    "over",
    [
        {},
        # a ray count that is no kernel-tile multiple; 5 bounces
        dict(resolution=(19, 7), samples_per_pixel=2, max_bounces=5),
        # quality mode: jittered camera (no primary-hit cache), cosine factor
        dict(camera=JITTER_CAMERA, parity=False),
        # a render tile smaller than the image: several scan steps
        dict(resolution=(32, 24), samples_per_pixel=1, max_bounces=4),
    ],
    ids=["base", "odd_resolution", "quality_jitter", "multi_tile"],
)
def test_kernel_engine_matches_mxu_engine(scene, over):
    img_k = _render(scene, "pallas", **over)
    img_m = _render(scene, "mxu", **over)
    np.testing.assert_allclose(img_k, img_m, atol=1e-5)


def test_auto_engine_is_the_backend_default(scene):
    """``auto`` resolves from the backend, never from an env flag: the
    XLA sweep off the GPU."""
    from pathtracerap.render.wavefront import resolve_engine

    r = Renderer(scene, RenderConfig(resolution=(8, 4), samples_per_pixel=1,
                                     max_bounces=2, camera=CAMERA))
    assert r.config.engine == "auto" and r.engine == "mxu"
    assert resolve_engine("pallas") == "pallas"
    with pytest.raises(ValueError):
        resolve_engine("fused")


def test_live_ray_curve(scene):
    import jax

    from pathtracerap.render.diagnostics import live_ray_curve

    cfg = RenderConfig(
        resolution=(16, 8), samples_per_pixel=1, max_bounces=4,
        camera=CAMERA, engine="mxu",
    )
    curve = live_ray_curve(scene, cfg, jax.random.PRNGKey(0))
    assert len(curve) == 4
    assert curve[0] == 1.0
    # monotone non-increasing decay (rays only die)
    assert all(a >= b for a, b in zip(curve, curve[1:]))


def test_render_tile_size_does_not_change_the_image(scene):
    """Tiles that are multiples of RNG_TILE draw per RNG_TILE sub-tile, so
    a longer render tile reproduces the default tile's image exactly."""
    import jax

    from pathtracerap.ops.rng import RNG_TILE
    from pathtracerap.render.wavefront import render_accumulate

    res = (128, 160)  # 20480 rays: 3 tiles of RNG_TILE, the last one ragged
    key = jax.random.PRNGKey(2)
    acc = [
        np.asarray(render_accumulate(
            scene, key, CAMERA, res, n_samples=1, max_bounces=2,
            engine="mxu", tile_size=tile,
        ))
        for tile in (RNG_TILE, 4 * RNG_TILE)
    ]
    np.testing.assert_array_equal(acc[0], acc[1])


def test_every_engine_has_a_default_tile_of_whole_rng_tiles():
    """``render_accumulate`` picks its tile from the resolved engine; each
    default is a multiple of RNG_TILE, so the choice never changes an
    image."""
    from pathtracerap.ops.rng import RNG_TILE
    from pathtracerap.render.wavefront import DEFAULT_TILE, ENGINES

    assert set(DEFAULT_TILE) == set(ENGINES)
    assert all(t % RNG_TILE == 0 for t in DEFAULT_TILE.values())
