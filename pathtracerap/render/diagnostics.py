"""Render diagnostics: the live-ray decay curve.

The reference's stream compaction makes the live-ray count an explicit
host-side number every bounce (``Renderer.cpp:629-634``); the masked
wavefront hides it inside liveness masks.  This module recomputes it on
demand — SURVEY.md section 5 asks for the "live-ray curve per bounce" in the
metrics stream (it is also the quantity that decides compaction strategy,
section 7 hard part c).
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..ops.rng import tile_uniforms
from ..scene.types import SceneDevice
from .camera import generate_rays
from .shade import RayState, shade
from .wavefront import _make_tracer, resolve_engine


def live_ray_curve(
    scene: SceneDevice,
    config: RenderConfig,
    key: jax.Array,
    sample_index: int = 0,
    max_rays: int = 65536,
) -> List[float]:
    """Fraction of rays still alive ENTERING each bounce of one sample.

    Index 0 is always 1.0 (primaries); index b is the fraction that still
    trace+shade at bounce b.  Uses at most ``max_rays`` rays for speed.
    """
    ro, rd = generate_rays(config.camera, config.resolution)
    ro, rd = ro[:max_rays], rd[:max_rays]
    n = ro.shape[0]
    tracer = _make_tracer(scene, resolve_engine(config.engine))

    @jax.jit
    def curve(ro, rd, key):
        state = RayState.primary(ro, rd, config.max_bounces)
        fracs = []
        for b in range(config.max_bounces):
            alive = state.remaining > 0
            fracs.append(jnp.mean(alive.astype(jnp.float32)))
            hits = tracer(state.orig, state.dir, alive=alive)
            depth = config.max_bounces - b
            u = tile_uniforms(key, sample_index, depth, 0, n)
            state = shade(state, hits, u, parity=config.parity)
        return jnp.stack(fracs)

    return [round(float(x), 4) for x in np.asarray(curve(ro, rd, key))]
