"""Quality-mode SPECULAR + REFRACTIVE shading (r5, VERDICT r4 item 8).

The reference declares both materials and carries ``refractive_index`` in
its data model (Primitive.h:70-84) but never branches on them
(Renderer.cpp:433-467).  Parity mode reproduces that pass-through; quality
mode shades them for real: perfect mirror and Fresnel-roulette dielectric.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pathtracerap.scene.dsl import (
    load_scene_file,
    parse_scene,
    render_config_from_parsed,
)

SCENES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes"
)
GLASS = os.path.join(SCENES, "glass_sphere.scn")


# ---------------------------------------------------------------------------
# unit: refract_scatter physics
# ---------------------------------------------------------------------------


def test_refract_scatter_normal_incidence():
    from pathtracerap.ops.sampling import refract_scatter

    n = jnp.asarray([[0.0, 0.0, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])  # head-on, entering
    ior = jnp.asarray([[1.5]])
    # Schlick at normal incidence: r0 = (0.5/2.5)^2 = 0.04
    dir_refract, orient = refract_scatter(n, d, ior, jnp.asarray([0.5]))
    np.testing.assert_allclose(np.asarray(dir_refract), [[0.0, 0.0, -1.0]],
                               atol=1e-6)
    assert float(orient[0, 0]) == -1.0  # transmitted: spawn below surface
    dir_reflect, orient_r = refract_scatter(n, d, ior, jnp.asarray([0.01]))
    np.testing.assert_allclose(np.asarray(dir_reflect), [[0.0, 0.0, 1.0]],
                               atol=1e-6)
    assert float(orient_r[0, 0]) == 1.0


def test_refract_scatter_snell_and_tir():
    from pathtracerap.ops.sampling import refract_scatter

    n = jnp.asarray([[0.0, 0.0, 1.0]])
    ior = jnp.asarray([[1.5]])
    # entering at 45 degrees: sin_t = sin(45)/1.5
    d = jnp.asarray([[np.sin(np.pi / 4), 0.0, -np.cos(np.pi / 4)]])
    out, orient = refract_scatter(n, d, ior, jnp.asarray([0.999]))
    sin_t = float(jnp.abs(out[0, 0]) / jnp.linalg.norm(out[0]))
    np.testing.assert_allclose(sin_t, np.sin(np.pi / 4) / 1.5, atol=1e-6)
    assert float(orient[0, 0]) == -1.0
    # EXITING beyond the critical angle (asin(1/1.5) ~ 41.8 deg): TIR must
    # reflect regardless of the roulette draw
    theta = np.deg2rad(60.0)
    d_exit = jnp.asarray([[np.sin(theta), 0.0, np.cos(theta)]])  # upward
    out_t, orient_t = refract_scatter(n, d_exit, ior, jnp.asarray([0.999]))
    assert float(orient_t[0, 0]) == -1.0  # stays inside: below the surface
    # direction reflects: z component flips sign
    assert float(out_t[0, 2]) < 0.0


def test_energy_directions_unit_norm():
    from pathtracerap.ops.sampling import refract_scatter

    k = jax.random.PRNGKey(0)
    n = jax.random.normal(k, (256, 3))
    n = n / jnp.linalg.norm(n, axis=1, keepdims=True)
    d = jax.random.normal(jax.random.fold_in(k, 1), (256, 3))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    ior = jnp.full((256, 1), 1.5)
    u = jax.random.uniform(jax.random.fold_in(k, 2), (256,))
    out, orient = refract_scatter(n, d, ior, u)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(out), axis=1), 1.0, atol=1e-5
    )
    assert set(np.unique(np.asarray(orient))) <= {-1.0, 1.0}


# ---------------------------------------------------------------------------
# scene-level behavior
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def glass():
    p = load_scene_file(GLASS)
    return p, p.scene.to_device()


def _render(p, dev, engine, parity, spp=4, res=(48, 36), bounces=4):
    from pathtracerap.config import RenderConfig
    from pathtracerap.render.wavefront import Renderer

    cfg = render_config_from_parsed(
        p, engine=engine, parity=parity, samples_per_pixel=spp,
        resolution=res, max_bounces=bounces,
    )
    return np.asarray(Renderer(dev, cfg).render())


def test_quality_mode_refraction_changes_the_image(glass):
    p, dev = glass
    img_q = _render(p, dev, "mxu", parity=False)
    img_p = _render(p, dev, "mxu", parity=True)
    assert np.isfinite(img_q).all() and img_q.max() > 0.05
    # parity mode burns bounces through glass/mirror unshaded — the two
    # modes must differ substantially where those materials are visible
    assert np.abs(img_q - img_p).max() > 0.05


def test_quality_refraction_engines_agree(glass):
    """Engines agree on virtually every pixel.  NOT exact: the Fresnel
    roulette (u < F) is a DISCRETE branch on a computed float, so a 1-ulp
    difference in a hit distance between the kernel and the XLA sweep can
    flip isolated reflect/refract decisions — the diffuse-scene engine
    tests stay bitwise because no such discontinuity exists there."""
    p, dev = glass
    img_m = _render(p, dev, "mxu", parity=False)
    img_k = _render(p, dev, "pallas", parity=False)
    mism = np.abs(img_k - img_m) > 1e-5
    frac = float(mism.mean())
    assert frac < 0.005, f"{frac:.4%} of components differ"
    # and the images agree in the aggregate
    assert abs(float(img_k.mean() - img_m.mean())) < 1e-3


def test_dsl_quality_flag_and_ri_plumbing(glass):
    p, dev = glass
    cfg = render_config_from_parsed(p)
    assert cfg.parity is False  # RENDER block: quality: true
    assert cfg.max_bounces == 6
    # the REFRACTIVE material's ior reached the device scene
    import numpy as _np

    assert _np.isclose(_np.asarray(dev.mat_refractive_index).max(), 1.5)


def test_committed_glass_golden(glass):
    from pathtracerap.io.bmp import read_bmp

    golden_path = os.path.join(
        os.path.dirname(SCENES), "assets", "golden", "glass_sphere.bmp"
    )
    if not os.path.exists(golden_path):
        pytest.skip("glass golden not committed yet")
    p, dev = glass
    img = _render(p, dev, "pallas", parity=False, spp=8, res=(96, 72),
                  bounces=6)
    gold = read_bmp(golden_path).astype(np.float32) / 255.0
    assert gold.shape == img.shape == (72, 96, 3)
    # renders are already gamma-2 tone mapped (gather_contribution);
    # compare downsampled stats (RNG/backends may differ in ulps that
    # chaos-amplify per pixel; structure and level must hold)
    d = lambda x: x.reshape(18, 4, 24, 4, 3).mean(axis=(1, 3))
    mad = float(np.abs(d(img) - d(gold)).mean())
    corr = float(np.corrcoef(d(img).ravel(), d(gold).ravel())[0, 1])
    assert mad < 0.04, mad
    assert corr > 0.97, corr


def test_parity_engine_carries_refractive_index(glass):
    """The DDA parity engine must report the scene's real ior (not the
    1.5 fallback) so quality-mode shading on it refracts correctly."""
    import jax.numpy as jnp

    from pathtracerap.ops.intersect import trace_parity
    from pathtracerap.render.camera import generate_rays
    from pathtracerap.config import CameraConfig

    from pathtracerap import constants

    p, dev = glass
    cam = CameraConfig(position=(0.0, 0.0, 110.0), plane_x=(-45.0, 45.0),
                       plane_y=(-38.0, 30.0), plane_z=60.0)
    ro, rd = generate_rays(cam, (32, 24))
    rec = trace_parity(dev, ro, rd)
    assert rec.mat_ri is not None
    hit = np.asarray(rec.t) < constants.FLOAT_MAX
    ri = np.asarray(rec.mat_ri)
    mt = np.asarray(rec.mat_type)
    refr = hit & (mt == 3)  # REFRACTIVE
    assert refr.any(), "camera should see the glass sphere"
    np.testing.assert_allclose(ri[refr], 1.5, atol=1e-6)
    # diffuse walls carry their (default 1.0) ior, not the fallback
    diff_hits = hit & (mt == 0)
    assert diff_hits.any()
    np.testing.assert_allclose(ri[diff_hits], 1.0, atol=1e-6)
