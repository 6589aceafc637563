"""Multi-chip rendering via jax.sharding + shard_map.

The reference has NO distributed support of any kind (SURVEY.md section 2:
no NCCL/MPI, single GPU, single process).  This module adds the capability
with ``jax.sharding`` + ``shard_map``:

* **ray/tile data parallelism** (the default): primary rays are sharded
  over the ``rays`` mesh axis, geometry is replicated; each device renders
  its own pixel rows with its own tile-indexed RNG streams, so the only
  communication is the final gather of image shards — the all-reduce-free
  regime the scaling-book recipe calls "pure DP over the batch".
* **sample parallelism**: every device renders all pixels for a disjoint
  subset of sample iterations, merged with one ``psum`` per render; useful
  when the image is small but spp is large.

Both compose with the single-device tile scan (render compile cost stays
resolution-independent), and both run unmodified on the CPU fake-device
mesh used by tests (``--xla_force_host_platform_device_count``).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..render.camera import generate_rays
from ..render.wavefront import (
    _make_tracer,
    _render_tile,
    render_ray_array,
    resolve_engine,
)
from ..scene.types import SceneDevice


def default_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the available devices, axis name ``rays``."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("rays",))


def render_accumulate_dp(
    scene: SceneDevice,
    key: jax.Array,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    mesh: Mesh,
    engine: str = "mxu",
    parity: bool = True,
    sample_offset: int = 0,
    world=None,
    tile_size: int = 2048,
):
    """Ray-sharded accumulation: returns the (N, 3) contribution sums.

    Rays are split evenly over the ``rays`` axis; ``scene``/``world`` are
    replicated (for scenes that fit — geometry sharding is the large-scene
    mode).  RNG tile indices are globally unique: device d's tiles start at
    ``d * tiles_per_device``, so with the same ``tile_size`` the image
    equals the single-device render of the same config.
    """
    n_dev = mesh.devices.size
    engine = resolve_engine(engine)
    # quality-mode AA camera (same rule as render_accumulate)
    jitter_step = None
    if camera.jitter:
        w_res, h_res = resolution
        jitter_step = (
            (camera.plane_x[1] - camera.plane_x[0]) / w_res,
            (camera.plane_y[1] - camera.plane_y[0]) / h_res,
        )
    ro, rd = generate_rays(camera, resolution)
    n = ro.shape[0]
    per_dev = -(-n // n_dev)
    per_dev = -(-per_dev // tile_size) * tile_size
    n_pad = per_dev * n_dev
    ro = jnp.pad(ro, ((0, n_pad - n), (0, 0)))
    rd = jnp.pad(rd, ((0, n_pad - n), (0, 0)), constant_values=1.0)
    tiles_per_dev = per_dev // tile_size

    def local_render(scene_l, world_l, key_l, ro_l, rd_l):
        tracer = _make_tracer(scene_l, engine, world=world_l)
        render_tile = functools.partial(
            _render_tile,
            tracer,
            key=key_l,
            n_samples=n_samples,
            max_bounces=max_bounces,
            parity=parity,
            sample_offset=sample_offset,
            scene=scene_l,
            jitter_step=jitter_step,
        )
        tile_base = jax.lax.axis_index("rays") * tiles_per_dev
        return render_ray_array(
            render_tile, ro_l, rd_l, tile_size, tile_base=tile_base
        )

    shard = jax.shard_map(
        local_render,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("rays"), P("rays")),
        out_specs=P("rays"),
        check_vma=False,
    )
    acc = shard(scene, world, key, ro, rd)
    return acc[:n]


@functools.partial(
    jax.jit,
    static_argnames=("camera", "resolution", "n_samples", "max_bounces", "engine",
                     "parity", "tile_size", "mesh"),
)
def _render_dp_jit(scene, key, camera, resolution, n_samples, max_bounces, mesh,
                   engine, parity, world, tile_size):
    return render_accumulate_dp(
        scene, key, camera, resolution, n_samples, max_bounces, mesh,
        engine=engine, parity=parity, world=world, tile_size=tile_size,
    )


def render_image_dp(
    scene: SceneDevice,
    config: RenderConfig,
    mesh: Optional[Mesh] = None,
    world=None,
    tile_size: int = 2048,
    seed: Optional[int] = None,
):
    """Full multi-device render; returns the (H, W, 3) float image."""
    from ..ops.plucker import bake_world_triangles

    if mesh is None:
        mesh = default_mesh()
    if world is None and resolve_engine(config.engine) != "parity":
        world = jax.jit(bake_world_triangles)(scene)
    key = jax.random.PRNGKey(config.seed if seed is None else seed)
    acc = _render_dp_jit(
        scene,
        key,
        config.camera,
        config.resolution,
        config.samples_per_pixel,
        config.max_bounces,
        mesh,
        config.engine,
        config.parity,
        world,
        tile_size,
    )
    w, h = config.resolution
    return acc.reshape(h, w, 3) / config.samples_per_pixel


def render_accumulate_sample_parallel(
    scene: SceneDevice,
    key: jax.Array,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    mesh: Mesh,
    engine: str = "mxu",
    parity: bool = True,
    world=None,
    tile_size: int = 2048,
):
    """Sample-sharded accumulation: each device renders every pixel for a
    disjoint slice of sample indices; one psum merges the images."""
    n_dev = mesh.devices.size
    if n_samples % n_dev:
        raise ValueError(f"n_samples={n_samples} not divisible by {n_dev} devices")
    per_dev = n_samples // n_dev

    def local_render(scene_l, world_l, key_l):
        d = jax.lax.axis_index("rays")
        ro, rd = generate_rays(camera, resolution)
        tracer = _make_tracer(scene_l, resolve_engine(engine), world=world_l)
        render_tile = functools.partial(
            _render_tile,
            tracer,
            key=key_l,
            n_samples=per_dev,
            max_bounces=max_bounces,
            parity=parity,
            sample_offset=d * per_dev,
            scene=scene_l,
        )
        acc = render_ray_array(render_tile, ro, rd, tile_size)
        return jax.lax.psum(acc, "rays")

    shard = jax.shard_map(
        local_render,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return shard(scene, world, key)
