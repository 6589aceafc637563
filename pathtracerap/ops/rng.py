"""Stateless counter-based RNG.

The reference seeds a fresh engine per (iteration, ray, depth) from a hash
(``utility.h:43-62``), which makes its random stream a pure function of those
three counters.  JAX's threefry with ``fold_in`` has exactly that contract:
``uniforms(key, sample, depth)[ray]`` is a pure function of
(key, sample, ray, depth), reproducible on any backend and trivially
shardable (each device computes its own rays' rows).

Numerical parity with thrust's minstd LCG sequence is deliberately *not*
attempted (SURVEY.md section 7 hard part b): parity is defined against this
framework's own oracle, which consumes the same uniforms.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Uniform draws provided per (ray, bounce).  The reference's materials draw at
# most 4 times from the engine (METAL draws 4, utility.h:150-157; COAT up to
# 3, utility.h:129-141; DIFFUSE 2, utility.h:96-98).
DRAWS_PER_BOUNCE = 4

# Rays per RNG stream: a ray tile longer than this draws as consecutive
# sub-tiles, so an image does not depend on the render tile size as long as
# the tile is a multiple of RNG_TILE.
RNG_TILE = 8192


def bounce_key(key: jax.Array, sample_index, depth) -> jax.Array:
    """Key for one (sample iteration, depth) wavefront step.

    ``depth`` mirrors the reference's use of ``remaining_bounces`` as the
    seed component (``Renderer.cpp:435``).
    """
    return jax.random.fold_in(jax.random.fold_in(key, sample_index), depth)


def tile_uniforms(key: jax.Array, sample_index, depth, tile_index, tile_n: int) -> jax.Array:
    """(tile_n, 4) uniforms for one ray tile of one wavefront shading step.

    The renderer processes the image in fixed-size ray tiles (the outer scan
    of the jitted program); folding the tile index in keeps every ray's
    stream independent while letting each tile draw locally.  Tiles up to
    RNG_TILE rays make the noise pattern a function of the tile size (still
    a valid stateless stream per (key, sample, depth, tile, lane)); longer
    tiles draw per RNG_TILE sub-tile, so e.g. 8192- and 65536-ray tiles
    render identical images.
    """
    return _tile_draws(
        bounce_key(key, sample_index, depth), tile_index, tile_n, DRAWS_PER_BOUNCE
    )


def _tile_draws(key: jax.Array, tile_index, tile_n: int, width: int) -> jax.Array:
    """(tile_n, width) uniforms of one ray tile.  A tile longer than
    RNG_TILE draws the streams of RNG-tile indices ``tile_index * m +
    (0..m-1)``, m = ceil(tile_n / RNG_TILE), and keeps the first tile_n
    rows."""
    if tile_n > RNG_TILE:
        m = -(-tile_n // RNG_TILE)
        subs = tile_index * m + jnp.arange(m)
        draw = lambda s: jax.random.uniform(
            jax.random.fold_in(key, s), (RNG_TILE, width), dtype=jnp.float32
        )
        return jax.vmap(draw)(subs).reshape(m * RNG_TILE, width)[:tile_n]
    k = jax.random.fold_in(key, tile_index)
    return jax.random.uniform(k, (tile_n, width), dtype=jnp.float32)


def sample_uniforms(key: jax.Array, sample_index, depth, n_rays: int) -> jax.Array:
    """(n_rays, 4) uniforms for a single-tile wavefront (tile index 0)."""
    return tile_uniforms(key, sample_index, depth, 0, n_rays)


def camera_jitter_uniforms(key: jax.Array, sample_index, tile_index, tile_n: int) -> jax.Array:
    """(tile_n, 2) sub-pixel jitter offsets in [0, 1) for one tile of one
    sample iteration (quality-mode camera AA; the reference never jitters,
    ``Renderer.cpp:538-545``).

    Uses depth=0 in the (sample, depth, tile) stream — shading steps consume
    depths ``max_bounces .. 1`` only, so camera draws never collide with
    BSDF draws.
    """
    return _tile_draws(bounce_key(key, sample_index, 0), tile_index, tile_n, 2)
