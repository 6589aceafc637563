"""Benchmark driver: forward path-tracing throughput on the reference scene.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Workload matches the reference's headline configuration
(``Config.h:12-19``): 1000x800 primary rays, 5 bounces, on the
backend's fast engine (``engine="auto"``).
Throughput counts ray-bounce traversals the way the reference's derived
upper bound does (SURVEY.md section 6: W*H*spp*bounces), i.e. dead lanes
count — the masked-wavefront analog of the reference's compacted launches.

vs_baseline is value / 100 (the BASELINE.json north-star target of
100 Mrays/s/chip); the reference itself publishes no numbers.
"""

from __future__ import annotations

import json
import time

import jax
import numpy as np


def main() -> None:
    from pathtracerap.config import RenderConfig
    from pathtracerap.render.wavefront import Renderer
    from pathtracerap.scene.build import build_reference_scene
    from pathtracerap.utils.profiling import enable_compile_cache

    enable_compile_cache()

    resolution = (1000, 800)
    # enough samples to amortize the fixed per-dispatch cost the way the
    # reference's 500-iteration run does (Renderer.cpp:582)
    spp = 24
    max_bounces = 5

    import jax.numpy as jnp

    scene = build_reference_scene().to_device()
    cfg = RenderConfig(
        resolution=resolution,
        samples_per_pixel=spp,
        max_bounces=max_bounces,
    )
    r = Renderer(scene, cfg)

    r.render().block_until_ready()  # warmup + compile

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        img = r.render().block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    img = np.asarray(img)

    rays = resolution[0] * resolution[1] * spp * max_bounces
    mrays = rays / dt / 1e6
    sanity = float(img.mean())
    assert 0.01 < sanity < 1.0, f"render sanity check failed: mean={sanity}"

    # fwd+bwd: one SGD step of the inverse renderer (pixel-loss grads via
    # the kernel-forward/recompute-backward diff path, diff/fast.py) on the
    # same scene; BASELINE metric line is "Mrays/s/chip fwd+bwd"
    import jax.random as jrandom

    from pathtracerap.diff.grad import extract_params, make_train_step

    bwd_spp = 8
    step = make_train_step(
        scene, cfg.camera, resolution, bwd_spp, max_bounces, tile_size=8192,
    )
    params = extract_params(scene, ("mat_color",))
    key = jrandom.PRNGKey(0)
    target = jnp.zeros((resolution[0] * resolution[1], 3), jnp.float32)
    loss, _ = step(params, target, key)  # compile + warmup
    loss.block_until_ready()
    tb = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss, _ = step(params, target, key)
        loss.block_until_ready()
        tb.append(time.perf_counter() - t0)
    rays_b = resolution[0] * resolution[1] * bwd_spp * max_bounces
    mrays_b = rays_b / min(tb) / 1e6
    assert float(loss) > 0.0 and jnp.isfinite(loss)

    print(
        json.dumps(
            {
                "metric": "fwd_path_trace_throughput",
                "value": round(mrays, 2),
                "unit": "Mrays/s/chip",
                "vs_baseline": round(mrays / 100.0, 4),
                "fwd_bwd_mrays_per_s": round(mrays_b, 2),
                "engine": r.engine,
                "device_kind": jax.devices()[0].device_kind,
            }
        )
    )


if __name__ == "__main__":
    main()
