"""Benchmark suite: the BASELINE.json forward configs as runnable benchmarks.

Configs (BASELINE.md "Benchmark configs"):
  1. cornell    — Cornell box, diffuse-only, 256x256, 4 bounces, 64 spp
  2. highpoly   — dense OBJ mesh traversal, 512x512, 8 bounces: the
                  committed 147k-triangle assets/meshes/highpoly_blob.obj
                  through the real import + uniform-grid build path (the
                  upstream bunny is git-LFS-missing,
                  PathTracerAP/.MISSING_LARGE_BLOBS)
  3. metallic   — the reference scene (3 METAL/COAT/REFLECTIVE monkeys,
                  README metallic render), 1024x1024, 256 spp
  4. multimesh  — multi-mesh mixed-material scene, 1024x1024, 1024 spp
  5. gridparity — the reference scene on the uniform-grid DDA parity
                  engine (the reference's own traversal algorithm)

Full-quality spp on configs 3/4 is hours of wall time; throughput is what
the baseline tracks, so each config times ``measure_spp`` samples and
reports Mrays/s (dead lanes counted, like the reference's derived bound —
SURVEY.md section 6) plus the wall time a full-spp render would take at
that rate.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from .config import CameraConfig, RenderConfig
from .scene.build import (
    SceneBuilder,
    build_cornell_box_scene,
    build_reference_scene,
    make_box_mesh,
    make_sphere_mesh,
)
from .scene.types import Material, MaterialType


def build_highpoly_scene(subdiv: int = 192, use_asset: bool = True):
    """A dense (~147k-triangle) OBJ mesh in a diffuse room.

    The committed ``assets/meshes/highpoly_blob.obj`` (a displaced sphere
    generated by ``scripts/make_highpoly_asset.py`` — the Stanford bunny
    is git-LFS-missing upstream) goes through the REAL asset path: OBJ
    import with BASE_MODEL_SCALE (``Scene.cpp:255-262``) + uniform-grid
    build, so config 2 exercises ``Scene.cpp:226-291``'s import semantics
    rather than an in-memory synthetic mesh (VERDICT r3 task 7).  Falls
    back to the synthetic sphere only if the asset is missing.
    """
    import os

    b = SceneBuilder()
    room = b.add_mesh(make_box_mesh(size=(400.0, 400.0, 400.0), inward=True))
    asset = os.path.join(os.path.dirname(__file__), "..", "assets", "meshes",
                         "highpoly_blob.obj")
    if use_asset and os.path.exists(asset):
        ball = b.add_mesh_file(asset)
        ball_translate = (0.0, -40.0, 0.0)
    else:
        ball = b.add_mesh(make_sphere_mesh(radius=80.0, subdiv=subdiv))
        ball_translate = (0.0, -40.0, 0.0)
    panel = b.add_mesh(make_box_mesh(size=(120.0, 4.0, 120.0)))
    M = MaterialType
    b.add_instance(room, Material(M.DIFFUSE, (0.9, 0.9, 0.9)))
    b.add_instance(ball, Material(M.DIFFUSE, (0.8, 0.3, 0.2)),
                   translate=ball_translate)
    b.add_instance(panel, Material(M.EMISSIVE, (1.0, 1.0, 1.0)),
                   translate=(0.0, 190.0, 0.0))
    return b.build()


def build_multimesh_scene():
    """Mixed materials over several meshes (BASELINE config 4)."""
    b = SceneBuilder()
    room = b.add_mesh(make_box_mesh(size=(400.0, 400.0, 400.0), inward=True))
    ball = b.add_mesh(make_sphere_mesh(radius=50.0, subdiv=48))
    cube = b.add_mesh(make_box_mesh(size=(70.0, 70.0, 70.0)))
    panel = b.add_mesh(make_box_mesh(size=(140.0, 4.0, 140.0)))
    M = MaterialType
    b.add_instance(room, Material(M.DIFFUSE, (0.85, 0.85, 0.85)))
    b.add_instance(ball, Material(M.METAL, (0.9, 0.7, 0.2)),
                   translate=(-90.0, -60.0, 20.0))
    b.add_instance(ball, Material(M.COAT, (0.3, 0.5, 0.9)),
                   translate=(90.0, -60.0, -30.0))
    b.add_instance(cube, Material(M.REFLECTIVE, (0.9, 0.9, 0.9)),
                   translate=(0.0, -120.0, -80.0), rotate_y_deg=30.0)
    b.add_instance(cube, Material(M.DIFFUSE, (0.2, 0.8, 0.3)),
                   translate=(20.0, -120.0, 100.0), rotate_y_deg=-20.0)
    b.add_instance(panel, Material(M.EMISSIVE, (1.0, 1.0, 1.0)),
                   translate=(0.0, 190.0, 0.0))
    return b.build()


_ROOM_CAMERA = CameraConfig(
    position=(0.0, 0.0, 380.0),
    plane_x=(-120.0, 120.0),
    plane_y=(-96.0, 96.0),
    plane_z=240.0,
)


def suite_configs() -> Dict[str, dict]:
    return {
        "cornell": dict(
            scene=build_cornell_box_scene,
            cfg=dict(resolution=(256, 256), samples_per_pixel=64, max_bounces=4,
                     camera=CameraConfig(position=(0.0, 0.0, 150.0),
                                         plane_x=(-40.0, 40.0),
                                         plane_y=(-40.0, 40.0),
                                         plane_z=100.0)),
            measure_spp=16,
        ),
        "highpoly": dict(
            scene=build_highpoly_scene,
            cfg=dict(resolution=(512, 512), samples_per_pixel=64, max_bounces=8,
                     camera=_ROOM_CAMERA),
            measure_spp=4,
        ),
        "metallic": dict(
            scene=build_reference_scene,
            cfg=dict(resolution=(1024, 1024), samples_per_pixel=256,
                     max_bounces=5),
            measure_spp=8,
        ),
        "multimesh": dict(
            scene=build_multimesh_scene,
            cfg=dict(resolution=(1024, 1024), samples_per_pixel=1024,
                     max_bounces=5, camera=_ROOM_CAMERA),
            measure_spp=8,
        ),
        # ~360k triangles: the largest scene of the suite
        "megascene": dict(
            scene=lambda: build_highpoly_scene(subdiv=300, use_asset=False),
            cfg=dict(resolution=(512, 512), samples_per_pixel=64,
                     max_bounces=6, camera=_ROOM_CAMERA),
            measure_spp=2,
        ),
        # "uniform-grid traversal" benchmarked with the engine that
        # actually runs the reference's per-mesh 25^3 grid DDA (the parity
        # engine, ops/intersect.py) — VERDICT r3 task 7: the grid engine
        # was never in the suite.  Reference scene at reduced size: the
        # DDA engine is the semantics/parity reference, not the fast path.
        "gridparity": dict(
            scene=build_reference_scene,
            cfg=dict(resolution=(256, 256), samples_per_pixel=8,
                     max_bounces=5),
            measure_spp=2,
            engine="parity",
        ),
    }


def _render_parity_stepwise(scene, cfg) -> np.ndarray:
    """Render with the uniform-grid DDA parity engine, one jitted
    (trace, shade) step per bounce driven from Python.

    Same math and RNG streams as the monolithic render program, with more
    dispatches: the row's throughput is dispatch-inclusive.  Whether the
    whole jitted program is the better driver is an open benchmark
    question (ROADMAP A6).
    """
    import jax
    import jax.numpy as jnp

    from .ops.intersect import trace_parity
    from .ops.rng import tile_uniforms
    from .render.camera import generate_rays
    from .render.shade import RayState, gather_contribution, shade

    ro, rd = generate_rays(cfg.camera, cfg.resolution)
    n = ro.shape[0]
    key = jax.random.PRNGKey(cfg.seed)

    trace_j = jax.jit(lambda o, d: trace_parity(scene, o, d))
    shade_j = jax.jit(
        lambda st, rec, u: shade(st, rec, u, parity=cfg.parity)
    )
    # the parity camera is jitterless: hoist the primary trace like the
    # reference's first-intersection cache (Renderer.cpp:594-613)
    hits0 = trace_j(ro, rd)
    acc = jnp.zeros((n, 3), jnp.float32)
    for s in range(cfg.samples_per_pixel):
        st = RayState.primary(ro, rd, cfg.max_bounces)
        for b in range(cfg.max_bounces):
            depth = cfg.max_bounces - b
            u = tile_uniforms(key, s, depth, 0, n)
            rec = hits0 if b == 0 else trace_j(st.orig, st.dir)
            st = shade_j(st, rec, u)
        acc = acc + gather_contribution(st)
    w, h = cfg.resolution
    return np.asarray(acc).reshape(h, w, 3) / cfg.samples_per_pixel


def run_config(name: str, engine: str = "auto", repeats: int = 2) -> dict:
    from .render.wavefront import Renderer

    spec = suite_configs()[name]
    engine = spec.get("engine", engine)  # per-config engine pin (gridparity)
    scene = spec["scene"]().to_device()
    spp = spec["measure_spp"]
    cfg = RenderConfig(engine=engine, **{**spec["cfg"],
                                         "samples_per_pixel": spp,
                                         "samples_per_chunk": spp})
    if engine == "parity":
        actual_engine = "parity"
        img = _render_parity_stepwise(scene, cfg)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            img = _render_parity_stepwise(scene, cfg)
            best = min(best, time.perf_counter() - t0)
    else:
        r = Renderer(scene, cfg)
        actual_engine = r.engine
        img = r.render().block_until_ready()
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            img = r.render().block_until_ready()
            best = min(best, time.perf_counter() - t0)
        img = np.asarray(img)
    w, h = cfg.resolution
    rays = w * h * spp * cfg.max_bounces
    mrays = rays / best / 1e6
    full_spp = spec["cfg"].get("samples_per_pixel", spp)
    return {
        "config": name,
        "engine": actual_engine,
        "resolution": [w, h],
        "full_spp": full_spp,
        "measured_spp": spp,
        "bounces": cfg.max_bounces,
        "triangles": int(scene.tri_vidx.shape[0]),
        "wall_s": round(best, 4),
        "mrays_per_s": round(mrays, 2) if mrays >= 0.1 else round(mrays, 4),
        "projected_full_render_s": round(best * full_spp / spp, 1),
        "image_mean": round(float(img.mean()), 5),
    }


def run_suite(which: str = "baseline", engine: str = "auto",
              names: Optional[List[str]] = None) -> dict:
    import jax

    if which != "baseline":
        raise ValueError(f"unknown suite {which!r}; only 'baseline' exists")
    names = names or list(suite_configs().keys())
    return {
        "suite": which,
        "device": str(jax.devices()[0]),
        "configs": [run_config(n, engine=engine) for n in names],
    }
