"""The wavefront render loop.

The reference's host-orchestrated pipeline of ~21 kernel launches per sample
iteration with full-device syncs between each (``Renderer.cpp:567-648``)
becomes ONE jitted XLA program:

* the image is processed as an outer ``lax.scan`` over fixed-size **ray
  tiles** — compile time and on-chip memory are independent of resolution;
* per tile, a ``lax.fori_loop`` runs the sample iterations; the (static)
  bounce loop of trace+shade steps is unrolled inside;
* the reference's first-intersection cache (``Renderer.cpp:594-613``)
  survives as hoisting the tile's primary-hit trace out of the sample loop —
  valid exactly when primary rays are deterministic (the jitterless parity
  camera);
* stream compaction (``Renderer.cpp:625-634``) is replaced by per-lane
  liveness masks inside :func:`~pathtracerap.render.shade.shade`.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..io.bmp import quantize_image, write_bmp
from ..ops.intersect import trace_parity
from ..ops.plucker import bake_world_triangles, trace_mxu
from ..ops.rng import tile_uniforms
from ..scene.types import SceneDevice
from .camera import generate_rays
from .shade import RayState, gather_contribution, shade

# Rays per render tile (one traversal call per bounce), by engine.
# Measured on an H100 SXM at 400 W (PERF.md): the kernel engine renders
# the reference workload 1.8x faster at 65536-ray tiles than at 8192,
# the XLA sweep ~6% slower; parity keeps 8192.  The RNG draws per
# ops.rng.RNG_TILE sub-tile, so the image does not change with the tile.
DEFAULT_TILE = {"parity": 8192, "mxu": 8192, "pallas": 65536}


ENGINES = ("parity", "mxu", "pallas")


def resolve_engine(engine: str) -> str:
    """Map ``"auto"`` to the backend's fast traversal engine: the Pallas
    kernel on the GPU, the XLA sweep (``mxu``) anywhere else."""
    if engine == "auto":
        return "pallas" if jax.default_backend() == "gpu" else "mxu"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine: {engine!r}")
    return engine


def _make_tracer(scene: SceneDevice, engine: str, world=None):
    """Tracers take (ro, rd, alive=None); engines that can exploit lane
    liveness (pallas block skipping) use it, the rest ignore it."""
    if engine == "parity":
        return lambda ro, rd, alive=None: trace_parity(scene, ro, rd)
    if engine in ("mxu", "pallas"):
        if world is None:
            world = bake_world_triangles(scene)
        if engine == "pallas":
            from ..pallas.trace import trace_pallas

            return lambda ro, rd, alive=None: trace_pallas(world, ro, rd, alive=alive)
        return lambda ro, rd, alive=None: trace_mxu(world, ro, rd)
    raise ValueError(f"unknown engine: {engine!r}")


def render_sample(
    scene: SceneDevice,
    ro: jax.Array,
    rd: jax.Array,
    key: jax.Array,
    sample_index,
    max_bounces: int,
    engine: str = "mxu",
    parity: bool = True,
    primary_hits=None,
    tracer=None,
    tile_index=0,
) -> jax.Array:
    """Path-trace one sample iteration for one ray tile; returns (n, 3)."""
    if tracer is None:
        tracer = _make_tracer(scene, engine)
    n = ro.shape[0]
    state = RayState.primary(ro, rd, max_bounces)

    # Bounce 0 outside the loop so the traversal appears at most twice in
    # the traced program — once for the cached/primary trace and once in
    # the fori_loop body — instead of max_bounces times: compile time
    # scales with the number of traversal instances.
    from ..utils.profiling import annotate

    with annotate("trace_primary"):
        hits0 = (
            primary_hits
            if primary_hits is not None
            else tracer(state.orig, state.dir, alive=state.remaining > 0)
        )
    with annotate("rng"):
        u0 = tile_uniforms(key, sample_index, max_bounces, tile_index, n)
    with annotate("shade"):
        state = shade(state, hits0, u0, parity=parity)

    def bounce_body(b, st):
        with annotate("trace"):
            hits = tracer(st.orig, st.dir, alive=st.remaining > 0)
        depth = max_bounces - b  # == remaining_bounces of live lanes (Renderer.cpp:435)
        with annotate("rng"):
            u = tile_uniforms(key, sample_index, depth, tile_index, n)
        with annotate("shade"):
            return shade(st, hits, u, parity=parity)

    if max_bounces > 1:
        state = jax.lax.fori_loop(1, max_bounces, bounce_body, state)

    with annotate("accumulate"):
        return gather_contribution(state)


def _render_tile(
    tracer,
    ro_t,
    rd_t,
    tile_index,
    key,
    n_samples: int,
    max_bounces: int,
    parity: bool,
    sample_offset,
    scene: SceneDevice,
    jitter_step=None,
):
    """All samples for one ray tile: fori_loop over samples, bounces unrolled.

    ``jitter_step`` = (pixel step_x, step_y) enables the quality-mode
    anti-aliasing camera: each sample perturbs the image-plane point by a
    sub-pixel uniform offset, so the primary-hit hoist (the reference's
    first-intersection cache, ``Renderer.cpp:594-613``) is disabled — it is
    only valid for the reference's deterministic jitterless camera.
    """
    from ..ops.rng import camera_jitter_uniforms

    primary = tracer(ro_t, rd_t) if jitter_step is None else None

    def body(i, acc):
        s = sample_offset + i
        if jitter_step is None:
            rd_s = rd_t
        else:
            ju = camera_jitter_uniforms(key, s, tile_index, ro_t.shape[0])
            # rd = pix - eye (Renderer.cpp:548); moving pix inside the pixel
            # footprint is a pure offset on the plane's (x, y) axes
            rd_s = rd_t + jnp.stack(
                [ju[:, 0] * jitter_step[0], ju[:, 1] * jitter_step[1],
                 jnp.zeros_like(ju[:, 0])], axis=-1,
            )
        contrib = render_sample(
            scene,
            ro_t,
            rd_s,
            key,
            s,
            max_bounces,
            parity=parity,
            primary_hits=primary,
            tracer=tracer,
            tile_index=tile_index,
        )
        return acc + contrib

    return jax.lax.fori_loop(
        0, n_samples, body, jnp.zeros((ro_t.shape[0], 3), jnp.float32)
    )


def render_ray_array(render_tile, ro, rd, tile_size: int, tile_base=0):
    """Run ``render_tile(ro_t, rd_t, tile_index)`` over an arbitrary ray
    array via an outer lax.scan of fixed-size tiles.

    ``tile_base`` offsets the tile indices (used by the sharded renderer so
    each device's tiles draw independent RNG streams).
    """
    n = ro.shape[0]
    if n <= tile_size:
        return render_tile(ro, rd, tile_base)

    n_pad = -(-n // tile_size) * tile_size
    ro_p = jnp.pad(ro, ((0, n_pad - n), (0, 0)))
    rd_p = jnp.pad(rd, ((0, n_pad - n), (0, 0)), constant_values=1.0)
    ro_tiles = ro_p.reshape(-1, tile_size, 3)
    rd_tiles = rd_p.reshape(-1, tile_size, 3)
    n_tiles = ro_tiles.shape[0]

    def scan_body(_, inp):
        ro_t, rd_t, k = inp
        return None, render_tile(ro_t, rd_t, tile_base + k)

    _, acc_tiles = jax.lax.scan(scan_body, None, (ro_tiles, rd_tiles, jnp.arange(n_tiles)))
    return acc_tiles.reshape(-1, 3)[:n]


@functools.partial(
    jax.jit,
    static_argnames=(
        "camera",
        "n_samples",
        "max_bounces",
        "engine",
        "parity",
        "resolution",
        "tile_size",
    ),
)
def render_accumulate(
    scene: SceneDevice,
    key: jax.Array,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    engine: str = "mxu",
    parity: bool = True,
    sample_offset: int = 0,
    init_accum: Optional[jax.Array] = None,
    world=None,
    tile_size: Optional[int] = None,
):
    """Accumulate ``n_samples`` sample iterations; returns (N, 3) sums.

    ``camera`` is a (hashable, frozen) CameraConfig treated as static;
    ``sample_offset`` supports checkpoint/resume chunking.  ``world`` is an
    optional pre-baked WorldTriangles (bake once per scene, outside the
    render program).  ``tile_size`` defaults to the engine's
    :data:`DEFAULT_TILE`.
    """
    engine = resolve_engine(engine)
    if tile_size is None:
        tile_size = DEFAULT_TILE[engine]
    ro, rd = generate_rays(camera, resolution)

    # quality-mode AA: per-sample sub-pixel jitter on the image plane; the
    # parity camera is jitterless like the reference (Renderer.cpp:538-545)
    jitter_step = None
    if camera.jitter:
        w_res, h_res = resolution
        jitter_step = (
            (camera.plane_x[1] - camera.plane_x[0]) / w_res,
            (camera.plane_y[1] - camera.plane_y[0]) / h_res,
        )

    tracer = _make_tracer(scene, engine, world=world)

    render_tile = functools.partial(
        _render_tile,
        tracer,
        key=key,
        n_samples=n_samples,
        max_bounces=max_bounces,
        parity=parity,
        sample_offset=sample_offset,
        scene=scene,
        jitter_step=jitter_step,
    )

    acc = render_ray_array(render_tile, ro, rd, tile_size)

    if init_accum is not None:
        acc = acc + init_accum
    return acc


class Renderer:
    """High-level facade: the analog of the reference's ``Renderer``
    lifecycle (``main.cpp:14-22``) minus the manual memory management."""

    def __init__(self, scene: SceneDevice, config: RenderConfig):
        self.scene = scene
        self.config = config
        self.engine = resolve_engine(config.engine)
        # bake once per scene; jitted so it runs on-device
        self.world = (
            jax.jit(bake_world_triangles)(scene) if self.engine != "parity" else None
        )

    def render(
        self,
        seed: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        metrics=None,
    ) -> jnp.ndarray:
        """Full render; returns the (H, W, 3) float image in [0, 1]
        (accumulated contributions / n_samples, pre-quantization).

        With ``checkpoint_path``, the accumulation state is saved after
        every sample chunk (atomic writes) and an interrupted render
        resumes exactly — the stateless per-(sample, ray, depth) RNG makes
        resumed samples identical to an unbroken run.
        """
        import time as _time

        cfg = self.config
        seed = cfg.seed if seed is None else seed
        key = jax.random.PRNGKey(seed)
        w, h = cfg.resolution

        from ..utils.debug import debug_enabled

        if debug_enabled() and self.engine == "pallas":
            # PTAP_DEBUG=1: checkify the kernel invariants on a slice of
            # primary rays before committing to the full render
            from ..utils.debug import checked_trace

            ro_d, rd_d = generate_rays(cfg.camera, cfg.resolution)
            checked_trace(self.world, ro_d[:8192], rd_d[:8192])
        chunk = cfg.samples_per_chunk or cfg.samples_per_pixel
        accum = None
        done = 0

        if checkpoint_path:
            from ..utils.checkpoint import load_checkpoint

            ck = load_checkpoint(checkpoint_path)
            if ck is not None:
                if ck.config != cfg.to_dict() or ck.seed != seed:
                    raise ValueError(
                        f"checkpoint {checkpoint_path} was written by a "
                        "different render config/seed; refusing to resume"
                    )
                accum = jnp.asarray(ck.accum)
                done = ck.samples_done

        if metrics is not None and getattr(metrics, "enabled", True) and done == 0:
            from .diagnostics import live_ray_curve

            metrics.record_live_curve(live_ray_curve(self.scene, cfg, key))

        while done < cfg.samples_per_pixel:
            step = min(chunk, cfg.samples_per_pixel - done)
            t0 = _time.perf_counter()
            accum = render_accumulate(
                self.scene,
                key,
                cfg.camera,
                cfg.resolution,
                n_samples=step,
                max_bounces=cfg.max_bounces,
                engine=self.engine,
                parity=cfg.parity,
                sample_offset=done,
                init_accum=accum,
                world=self.world,
            )
            done += step
            if checkpoint_path or metrics:
                accum_host = jax.device_get(accum)  # also syncs for timing
                if metrics:
                    metrics.chunk_done(step, _time.perf_counter() - t0)
                if checkpoint_path:
                    from ..utils.checkpoint import RenderCheckpoint, save_checkpoint

                    save_checkpoint(
                        checkpoint_path,
                        RenderCheckpoint(
                            accum=accum_host,
                            samples_done=done,
                            seed=seed,
                            config=cfg.to_dict(),
                        ),
                    )
        image = accum.reshape(h, w, 3) / cfg.samples_per_pixel
        return image

    def render_to_bmp(self, path: str, seed: Optional[int] = None) -> jnp.ndarray:
        image = self.render(seed=seed)
        accum = jax.device_get(image) * self.config.samples_per_pixel
        write_bmp(path, quantize_image(accum, self.config.samples_per_pixel))
        return image


def render_image(scene: SceneDevice, config: RenderConfig, seed: Optional[int] = None):
    """One-call convenience: returns (H, W, 3) float image."""
    return Renderer(scene, config).render(seed=seed)
