"""Scene DSL, checkpoint/resume, metrics, and CLI tests."""

import json
import os

import numpy as np
import pytest

from pathtracerap.cli import main as cli_main
from pathtracerap.config import RenderConfig
from pathtracerap.scene.dsl import (
    SceneParseError,
    parse_scene,
    render_config_from_parsed,
)

SCENE_TEXT = """
# materials
DIFFUSE white
color: [0.9, 0.9, 0.9]

EMISSIVE lamp
color: [0.99, 0.99, 0.99]

METAL chrome
color: [0.8, 0.8, 0.9]

BOX room
min: [-100, -100, -100]
max: [100, 100, 100]
material: white

SPHERE ball
radius: 20
subdiv: 8
translate: [0, -40, 0]
material: chrome

BOX panel
min: [-30, -2, -30]
max: [30, 2, 30]
translate: [0, 95, 0]
material: lamp

CAMERA
position: [0, 0, 90]
plane_x: [-40, 40]
plane_y: [-40, 40]
plane_z: 60

RENDER
resolution: [24, 24]
spp: 4
bounces: 3
engine: mxu
"""


def test_dsl_parses_and_builds():
    p = parse_scene(SCENE_TEXT)
    assert p.scene.num_models == 3
    # sphere with subdiv 8: lat=8, lon=16 -> 2*16 caps + 6*16*2 = fine, >0
    assert p.scene.num_triangles > 100
    cfg = render_config_from_parsed(p)
    assert cfg.resolution == (24, 24)
    assert cfg.samples_per_pixel == 4
    assert cfg.max_bounces == 3
    assert cfg.camera.position == (0, 0, 90)


def test_dsl_renders(tmp_path):
    from pathtracerap.render.wavefront import Renderer

    p = parse_scene(SCENE_TEXT)
    cfg = render_config_from_parsed(p)
    img = np.asarray(Renderer(p.scene.to_device(), cfg).render())
    assert img.shape == (24, 24, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.05


def test_dsl_errors():
    with pytest.raises(SceneParseError, match="unknown material"):
        parse_scene("BOX b\nmaterial: nope\n")
    with pytest.raises(SceneParseError, match="no entity"):
        parse_scene("DIFFUSE d\ncolor: [1,1,1]\n")
    with pytest.raises(SceneParseError, match="outside any block"):
        parse_scene("color: [1,1,1]\n")


def test_checkpoint_roundtrip(tmp_path):
    from pathtracerap.utils.checkpoint import (
        RenderCheckpoint,
        load_checkpoint,
        save_checkpoint,
    )

    path = str(tmp_path / "r.ckpt")
    accum = np.random.default_rng(0).random((64, 3)).astype(np.float32)
    ck = RenderCheckpoint(
        accum=accum, samples_done=5, seed=3,
        config=RenderConfig().to_dict(), extra={"opt": np.arange(4.0)},
    )
    save_checkpoint(path, ck)
    back = load_checkpoint(path)
    np.testing.assert_array_equal(back.accum, accum)
    assert back.samples_done == 5 and back.seed == 3
    assert back.config == RenderConfig().to_dict()
    np.testing.assert_array_equal(back.extra["opt"], np.arange(4.0))
    assert load_checkpoint(str(tmp_path / "missing.ckpt")) is None


def test_render_resume_is_exact(tmp_path):
    """Interrupted + resumed render == unbroken render, bit-for-bit."""
    from pathtracerap.config import CameraConfig
    from pathtracerap.render.wavefront import Renderer
    from pathtracerap.scene.build import build_cornell_box_scene

    scene = build_cornell_box_scene().to_device()
    cam = CameraConfig(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0),
                       plane_y=(-30.0, 30.0), plane_z=100.0)
    cfg = RenderConfig(resolution=(16, 8), samples_per_pixel=6,
                       samples_per_chunk=2, max_bounces=2, camera=cam,
                       engine="mxu")
    full = np.asarray(Renderer(scene, cfg).render())

    ckpt = str(tmp_path / "resume.ckpt")
    r = Renderer(scene, cfg)
    # simulate an interrupt: run only the first chunk by rendering with a
    # truncated spp, writing the checkpoint
    cfg_short = RenderConfig(resolution=(16, 8), samples_per_pixel=2,
                             samples_per_chunk=2, max_bounces=2, camera=cam,
                             engine="mxu")
    # manual first chunk with checkpoint
    import dataclasses
    r_short = Renderer(scene, dataclasses.replace(cfg, samples_per_pixel=2))
    # writing a checkpoint whose config matches the FULL config
    from pathtracerap.render.wavefront import render_accumulate
    import jax

    key = jax.random.PRNGKey(cfg.seed)
    acc = render_accumulate(scene, key, cam, cfg.resolution, n_samples=2,
                            max_bounces=2, engine="mxu", world=r.world)
    from pathtracerap.utils.checkpoint import RenderCheckpoint, save_checkpoint

    save_checkpoint(ckpt, RenderCheckpoint(
        accum=np.asarray(acc), samples_done=2, seed=cfg.seed,
        config=cfg.to_dict(),
    ))
    resumed = np.asarray(Renderer(scene, cfg).render(checkpoint_path=ckpt))
    np.testing.assert_array_equal(resumed, full)


def test_checkpoint_config_mismatch_refused(tmp_path):
    import dataclasses

    from pathtracerap.config import CameraConfig
    from pathtracerap.render.wavefront import Renderer
    from pathtracerap.scene.build import build_cornell_box_scene
    from pathtracerap.utils.checkpoint import RenderCheckpoint, save_checkpoint

    scene = build_cornell_box_scene().to_device()
    cam = CameraConfig(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0),
                       plane_y=(-30.0, 30.0), plane_z=100.0)
    cfg = RenderConfig(resolution=(16, 8), samples_per_pixel=4, max_bounces=2,
                       camera=cam, engine="mxu")
    other = dataclasses.replace(cfg, max_bounces=3)
    ckpt = str(tmp_path / "bad.ckpt")
    save_checkpoint(ckpt, RenderCheckpoint(
        accum=np.zeros((16 * 8, 3), np.float32), samples_done=2,
        seed=0, config=other.to_dict(),
    ))
    with pytest.raises(ValueError, match="different render config"):
        Renderer(scene, cfg).render(checkpoint_path=ckpt)


def test_cli_render_and_info(tmp_path, capsys):
    scene_file = tmp_path / "scene.txt"
    scene_file.write_text(SCENE_TEXT)
    out = tmp_path / "out.bmp"

    rc = cli_main([
        "render", "--scene", str(scene_file), "--out", str(out), "--quiet",
    ])
    assert rc == 0
    assert out.exists()
    from pathtracerap.io.bmp import read_bmp

    img = read_bmp(str(out))
    assert img.shape == (24, 24, 3)

    rc = cli_main(["info", "--scene", str(scene_file)])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["models"] == 3


def test_cli_invert_self_demo(tmp_path, capsys):
    scene_file = tmp_path / "scene.txt"
    scene_file.write_text(SCENE_TEXT)
    rc = cli_main([
        "invert", "--scene", str(scene_file), "--steps", "3", "--spp", "2",
        "--bounces", "2",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("step ")]
    assert len(lines) == 3
    l0 = float(lines[0].split("loss=")[1])
    l2 = float(lines[2].split("loss=")[1])
    assert l2 < l0  # loss decreases


def test_cli_invert_checkpoint_resume_matches_unbroken(tmp_path, capsys):
    """VERDICT r4 item 9: kill-and-resume an invert run reproduces the
    unbroken run's params exactly (optimizer state rides
    RenderCheckpoint.extra)."""
    import re

    scene_file = tmp_path / "scene.txt"
    scene_file.write_text(SCENE_TEXT)
    common = ["invert", "--scene", str(scene_file), "--spp", "2",
              "--bounces", "2"]

    def final_params(out):
        tail = out.split("optimized mat_color:")[1]
        return np.asarray(
            [float(x) for x in re.findall(r"-?\d+\.\d+", tail)], np.float32
        )

    rc = cli_main(common + ["--steps", "4"])
    assert rc == 0
    unbroken = final_params(capsys.readouterr().out)

    # "killed" run: 2 steps with a checkpoint...
    ck = str(tmp_path / "invert.ckpt.npz")
    rc = cli_main(common + ["--steps", "2", "--checkpoint", ck])
    assert rc == 0
    capsys.readouterr()
    # ...resumed to 4
    rc = cli_main(common + ["--steps", "4", "--checkpoint", ck])
    assert rc == 0
    out = capsys.readouterr().out
    assert "resuming from step 2" in out
    resumed = final_params(out)
    np.testing.assert_allclose(resumed, unbroken, rtol=1e-6, atol=1e-7)

    # mismatched config must refuse
    with pytest.raises(SystemExit, match="different invert config"):
        cli_main(common + ["--steps", "4", "--checkpoint", ck, "--lr", "0.05"])


def test_cli_invert_dp_matches_single_device(tmp_path, capsys):
    """--dp shards the train step over the 8 fake devices; with the
    sum-loss lr rescale its printed mean loss decreases like the
    single-device path's."""
    scene_file = tmp_path / "scene.txt"
    scene_file.write_text(SCENE_TEXT)
    rc = cli_main([
        "invert", "--scene", str(scene_file), "--steps", "3", "--spp", "2",
        "--bounces", "2", "--dp",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("step ")]
    assert len(lines) == 3
    assert float(lines[2].split("loss=")[1]) < float(lines[0].split("loss=")[1])


def test_dsl_lowercase_booleans():
    """`quality: false` must actually disable quality mode (bool("false")
    is True — the r5 review catch)."""
    from pathtracerap.scene.dsl import _parse_value

    assert _parse_value("true") is True
    assert _parse_value("false") is False
    assert _parse_value("True") is True
    assert _parse_value("no") is False
    assert _parse_value("0.5") == 0.5
    assert _parse_value("some_name") == "some_name"

    p = parse_scene(SCENE_TEXT + "\nRENDER\nquality: false\n")
    cfg = render_config_from_parsed(p)
    assert cfg.parity is True
    p2 = parse_scene(SCENE_TEXT + "\nRENDER\nquality: true\n")
    assert render_config_from_parsed(p2).parity is False
