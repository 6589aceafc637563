"""Benchmark-suite scenes build and render sanely (tiny shapes on CPU)."""

import numpy as np
import pytest

from pathtracerap.bench_suite import (
    _ROOM_CAMERA,
    build_highpoly_scene,
    build_multimesh_scene,
    suite_configs,
)
from pathtracerap.config import RenderConfig
from pathtracerap.render.wavefront import Renderer


def test_suite_configs_cover_baseline():
    names = set(suite_configs().keys())
    assert names == {"cornell", "highpoly", "metallic", "multimesh",
                     "gridparity", "megascene"}


def test_multimesh_scene_renders():
    scene = build_multimesh_scene()
    assert scene.num_models == 6
    img = np.asarray(
        Renderer(
            scene.to_device(),
            RenderConfig(resolution=(32, 24), samples_per_pixel=1, max_bounces=3,
                         camera=_ROOM_CAMERA, engine="pallas"),
        ).render()
    )
    assert np.all(np.isfinite(img)) and img.max() > 0.01


def test_engine_routing_by_scene_size():
    """Every scene size bakes the kernel pack — there is no size cap and
    no dense fallback — and ``auto`` resolves from the backend alone."""
    import jax

    from pathtracerap.ops.plucker import bake_world_triangles
    from pathtracerap.pallas.trace import FRUSTUM_LIST_THRESHOLD
    from pathtracerap.render.wavefront import resolve_engine

    for subdiv in (128, 224):  # ~66k and ~200k triangles
        scene = build_highpoly_scene(subdiv=subdiv, use_asset=False)
        world = jax.jit(bake_world_triangles)(scene.to_device())
        nb = world.block_aabb.shape[0]
        assert nb > FRUSTUM_LIST_THRESHOLD
        assert world.tri_pack.shape == (22, world.num_triangles)
        assert nb * world.tri_block >= world.n_valid
    assert resolve_engine("auto") == "mxu"  # the CPU test backend


def test_highpoly_regime_renders_on_binned_worklists():
    scene = build_highpoly_scene(subdiv=128, use_asset=False)
    img = np.asarray(
        Renderer(
            scene.to_device(),
            RenderConfig(resolution=(24, 16), samples_per_pixel=1, max_bounces=2,
                         camera=_ROOM_CAMERA, engine="pallas"),
        ).render()
    )
    assert np.all(np.isfinite(img)) and img.max() > 0.01
