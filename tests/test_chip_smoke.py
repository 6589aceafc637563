"""``chip_smoke.py``: its contract off the GPU, and its phase functions at
tiny sizes with the kernel in the Pallas interpreter.  The ``gpu`` tests
run the kernel check of the smoke's kernel phase on a real card."""

import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cornell():
    from pathtracerap.scene.build import build_cornell_box_scene

    return build_cornell_box_scene().to_device()


@pytest.fixture(scope="module")
def small_highpoly():
    from pathtracerap.bench_suite import build_highpoly_scene

    return build_highpoly_scene(subdiv=24, use_asset=False).to_device()


def test_smoke_exits_nonzero_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs an NVIDIA GPU" in p.stderr


def test_bake_check_passes(smoke, cornell):
    out = smoke.check_bake(cornell)
    assert out["sorted_order_identical"]
    assert out["v0"] == 0.0  # CPU against CPU here


def test_kernel_phase_at_tiny_size(smoke, small_highpoly):
    from pathtracerap.scene.build import build_reference_scene

    out = smoke.phase_kernel(build_reference_scene().to_device(), small_highpoly,
                             ref_res=(40, 32), hp_res=(24, 16))
    for k in ("reference_primary", "reference_secondary", "highpoly_primary"):
        assert out[k]["index_agreement_with_ties"] >= 0.9999
        assert out[k]["rays"] > 0
    assert out["reference_primary"]["hit_fraction"] > 0.5


def test_kernel_agreement_flags_a_wrong_engine(smoke, cornell):
    """The check must fail when the kernel is given different geometry."""
    from pathtracerap.ops.plucker import bake_world_triangles
    from pathtracerap.render.camera import generate_rays
    from pathtracerap.config import CameraConfig

    world = bake_world_triangles(cornell)
    shifted = world.replace(tri_pack=world.tri_pack.at[21].add(50.0))
    ro, rd = generate_rays(CameraConfig(position=(0.0, 0.0, 150.0),
                                        plane_x=(-40.0, 40.0), plane_y=(-30.0, 30.0),
                                        plane_z=100.0), (16, 8))
    stats = smoke.kernel_agreement(shifted, ro, rd)
    with pytest.raises(AssertionError):
        smoke.assert_kernel_agreement(stats)


def test_forward_phase_at_tiny_size(smoke, cornell):
    out = smoke.phase_forward(cornell, res=(16, 8), spp=2)
    assert out["engine"] == "mxu"  # the CPU backend's default engine
    assert out["vs_mxu"]["mean_abs_diff"] == 0.0


def test_golden_agreement_of_the_golden_itself(smoke):
    from pathtracerap.io.bmp import read_bmp

    path = os.path.join(ROOT, "assets", "golden", "reference_scene.bmp")
    img = read_bmp(path).astype(np.float32) / 255.0
    out = smoke.golden_agreement(img, path)
    assert out["mad"] == 0.0
    with pytest.raises(AssertionError):
        smoke.golden_agreement(img * 0.5, path)


def test_train_phase_at_tiny_size(smoke, cornell):
    out = smoke.phase_train(cornell, res=(16, 8), grad_res=(16, 8), steps=2,
                            n_samples=1)
    assert len(out["mat_color"]["losses"]) == 2
    assert set(out["grads_vs_mxu"]) == {"mat_color", "vertex_pos"}
    assert out["grads_vs_mxu"]["vertex_pos"]["entries_off"] == 0


def test_timings_phase_at_tiny_size(smoke, cornell, small_highpoly):
    out = smoke.phase_timings(cornell, small_highpoly, ref_res=(16, 8),
                              hp_res=(8, 8), spp=1, repeats=1,
                              tiles=(("pallas", (64, 128)), ("mxu", (64,))))
    assert out["reference_call_8192"]["rays"] == 128
    assert out["render_pallas"]["median_s"] > 0.0
    assert {"render_pallas_tile_128", "render_mxu_tile_64"} <= set(out)


def test_four_card_phase_on_virtual_devices(smoke, cornell):
    out = smoke.phase_four_cards(cornell, res=(16, 8), spp=1, grad_res=(16, 8),
                                 ring_res=(16, 8), tile=16)
    assert out["devices"] == len(jax.devices())
    assert out["dp_render_max_abs_diff"] <= 1e-6


@pytest.mark.gpu
def test_kernel_matches_sweep_on_gpu(gpu_backend, smoke):
    """The smoke's kernel check on the reference scene's primaries."""
    from pathtracerap.config import RenderConfig
    from pathtracerap.ops.plucker import bake_world_triangles
    from pathtracerap.render.camera import generate_rays
    from pathtracerap.scene.build import build_reference_scene

    world = jax.jit(bake_world_triangles)(build_reference_scene().to_device())
    ro, rd = generate_rays(RenderConfig().camera, (1000, 800))
    smoke.assert_kernel_agreement(smoke.kernel_agreement(world, ro, rd))


@pytest.mark.gpu
def test_bake_matches_cpu_bake_on_gpu(gpu_backend, smoke):
    from pathtracerap.scene.build import build_reference_scene

    smoke.check_bake(build_reference_scene().to_device())
