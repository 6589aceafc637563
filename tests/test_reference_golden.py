"""End-to-end parity against the reference's committed render.

The reference repository commits ``PathTracerAP/Render.bmp`` (1000x800,
written by Renderer.cpp:15-63).  RNG sequences differ by design (SURVEY.md
section 7 hard part b), so the comparison is on downsampled images, where
per-pixel sampling noise averages out and what remains is camera,
transform, material and traversal semantics — exactly the things that
would drift (r1 VERDICT missing item 1).

The repo's own golden (assets/golden/reference_scene.bmp, produced by
scripts/make_golden.py) is committed and doubles as the regression anchor
for a small CPU re-render.
"""

import os

import numpy as np
import pytest

from pathtracerap.io.bmp import read_bmp

GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "golden", "reference_scene.bmp",
)
REFERENCE = "/root/reference/PathTracerAP/Render.bmp"


def _down(x, f):
    h, w, _ = x.shape
    return x[: h - h % f, : w - w % f].reshape(h // f, f, w // f, f, 3).mean(
        axis=(1, 3)
    )


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="golden not committed")
@pytest.mark.skipif(not os.path.exists(REFERENCE), reason="reference not mounted")
def test_committed_golden_matches_reference_render():
    ours = read_bmp(GOLDEN).astype(np.float32) / 255.0
    ref = read_bmp(REFERENCE).astype(np.float32) / 255.0
    assert ours.shape == ref.shape == (800, 1000, 3)
    d_ours, d_ref = _down(ours, 8), _down(ref, 8)
    mad = float(np.abs(d_ours - d_ref).mean())
    corr = float(np.corrcoef(d_ours.ravel(), d_ref.ravel())[0, 1])
    # channel means catch RGB swaps / gamma drift
    ch = np.abs(ours.mean(axis=(0, 1)) - ref.mean(axis=(0, 1)))
    # Bounds pinned from the r4 measurement with ~2x headroom (measured:
    # mad 0.0121, corr 0.9976, channel drift <= 0.0016 — the residual is
    # RNG-stream noise + the reference's DDA early-exit quirk on secondary
    # occlusion).  r3's looser 0.06/0.93/0.08 bounds could not have caught
    # a subtle material-color or spawn-offset regression (VERDICT r3 weak
    # item 6); these can.
    assert mad < 0.025, f"downsampled mean|diff|={mad:.4f}"
    assert corr > 0.99, f"structural correlation={corr:.4f}"
    assert np.all(ch < 0.008), f"channel mean drift {ch}"


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="golden not committed")
def test_small_render_matches_committed_golden():
    """Drift guard: a fresh tiny render must still match the committed
    golden after heavy downsampling (fails if camera/transform/material
    semantics change)."""
    import jax

    from pathtracerap.config import RenderConfig
    from pathtracerap.render.wavefront import Renderer
    from pathtracerap.scene.build import build_reference_scene

    res = (100, 80)
    img = np.asarray(
        Renderer(
            build_reference_scene().to_device(),
            RenderConfig(resolution=res, samples_per_pixel=4, max_bounces=5,
                         engine="mxu"),
        ).render(seed=5)
    )
    golden = read_bmp(GOLDEN).astype(np.float32) / 255.0
    g_small = _down(golden, 10)  # 1000x800 -> 100x80
    assert g_small.shape == img.shape
    a = _down(img, 4)  # -> 25x20: wash out the 4spp noise
    b = _down(g_small, 4)
    mad = float(np.abs(a - b).mean())
    corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    assert mad < 0.08, f"mean|diff| vs golden = {mad:.4f}"
    assert corr > 0.9, f"correlation vs golden = {corr:.4f}"


DIFFUSE_GOLDEN = os.path.join(os.path.dirname(GOLDEN), "diffuse_reference.bmp")
PARITY_GOLDEN = os.path.join(os.path.dirname(GOLDEN), "reference_scene_parity.bmp")


@pytest.mark.skipif(not os.path.exists(DIFFUSE_GOLDEN), reason="golden not committed")
def test_small_render_matches_diffuse_golden():
    """Second golden (r2 VERDICT item 8): the diffuse-monkeys configuration
    (scenes/diffuse_reference.scn — the reproducible counterpart of the
    reference's render1/render2_diffuse_refl.bmp family, whose Stanford
    meshes are LFS-missing upstream).  A fresh tiny render must match the
    committed golden after downsampling."""
    from pathtracerap.render.wavefront import Renderer
    from pathtracerap.scene.dsl import load_scene_file, render_config_from_parsed

    scn = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scenes", "diffuse_reference.scn")
    p = load_scene_file(scn)
    cfg = render_config_from_parsed(
        p, resolution=(100, 80), samples_per_pixel=4, engine="mxu")
    img = np.asarray(Renderer(p.scene.to_device(), cfg).render(seed=5))
    golden = read_bmp(DIFFUSE_GOLDEN).astype(np.float32) / 255.0
    g_small = _down(golden, 10)
    a = _down(img, 4)
    b = _down(g_small, 4)
    mad = float(np.abs(a - b).mean())
    corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    assert mad < 0.08, f"mean|diff| vs diffuse golden = {mad:.4f}"
    assert corr > 0.9, f"correlation vs diffuse golden = {corr:.4f}"


@pytest.mark.skipif(not os.path.exists(PARITY_GOLDEN), reason="golden not committed")
def test_parity_engine_golden_matches_fused_golden():
    """The DDA parity engine rendered the reference scene at full 1000x800
    (scripts/make_golden_parity.py, 2 spp).

    The committed parity render agrees STRUCTURALLY with the soup-engine
    golden
    (correlation > 0.94) with a small uniform brightness offset
    (mean|diff| ~ 0.076): the per-model AABB gate + DDA early-exit
    semantics the parity engine reproduces (Renderer.cpp:252, 326-329)
    really do change secondary-ray occlusion vs the always-nearest soup
    engines.  On primary rays the parity engine matches the scalar oracle
    transliteration exactly (verified per-ray: both reject the EPS-slack
    sliver hits outside a model's AABB that the soup engines accept).
    The bounds below pin today's measured relationship two-sided."""
    q = read_bmp(PARITY_GOLDEN).astype(np.float32) / 255.0
    g = read_bmp(GOLDEN).astype(np.float32) / 255.0
    assert q.shape == g.shape == (800, 1000, 3)
    dq, dg = _down(q, 8), _down(g, 8)
    mad = float(np.abs(dq - dg).mean())
    corr = float(np.corrcoef(dq.ravel(), dg.ravel())[0, 1])
    ch = np.abs(q.mean(axis=(0, 1)) - g.mean(axis=(0, 1)))
    # two-sided pin of the r4-measured relationship (mad 0.0759,
    # corr 0.9509): a DISAPPEARING offset would mean the parity engine's
    # AABB-gate/early-exit semantics silently changed
    assert 0.05 < mad < 0.09, f"downsampled mean|diff|={mad:.4f}"
    assert corr > 0.945, f"structural correlation={corr:.4f}"
    assert np.all(ch < 0.09), f"channel mean drift {ch}"
