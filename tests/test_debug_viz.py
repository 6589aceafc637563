"""Debug visualizer AOV tests."""

import numpy as np

from pathtracerap.config import CameraConfig, RenderConfig
from pathtracerap.render.debug_viz import render_aovs, write_aov_bmps
from pathtracerap.scene.build import build_cornell_box_scene

CFG = RenderConfig(
    resolution=(24, 16),
    camera=CameraConfig(
        position=(0.0, 0.0, 150.0),
        plane_x=(-40.0, 40.0),
        plane_y=(-30.0, 30.0),
        plane_z=100.0,
    ),
)


def test_aovs_have_sane_content():
    scene = build_cornell_box_scene().to_device()
    aovs = render_aovs(scene, CFG)
    assert aovs["depth"].shape == (16, 24)
    assert aovs["hit"].mean() > 0.9  # camera inside the room: almost all hit
    d = aovs["depth"][aovs["hit"]]
    assert np.isfinite(d).all() and d.min() > 0
    # traversal did real work
    assert aovs["dda_steps"].max() > 1
    assert aovs["tri_tests"].max() > 1
    # normals unit length where hit
    n = aovs["normal"][aovs["hit"]]
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-4)


def test_aov_bmps_written(tmp_path):
    scene = build_cornell_box_scene().to_device()
    paths = write_aov_bmps(scene, CFG, str(tmp_path / "aovs"))
    assert set(paths) == {
        "depth", "normal", "mat_type", "albedo", "hit", "dda_steps", "tri_tests"
    }
    from pathtracerap.io.bmp import read_bmp

    for p in paths.values():
        img = read_bmp(p)
        assert img.shape == (16, 24, 3)
