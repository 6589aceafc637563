"""Bring-up check of the renderer on one NVIDIA GPU.

    python chip_smoke.py              # phases 1-6 on one card
    python chip_smoke.py --four-cards # only the four-card phase

Drives the main path through the entry points a user calls
(``Renderer.render``, ``diff.grad.make_train_step``) at the reference's
headline 1000x800, 5 bounces, runs the Pallas traversal kernel as Triton
compiled it (never interpreted) and compares every result with the plain
XLA sweep (``trace_mxu`` at HIGHEST precision).  Each phase prints one
``phase <name>: {json}`` line; the card's name and power limit follow, as
``nvidia-smi`` reports them, and the last line is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, so the script exits non-zero and prints no
result.  It also exits non-zero when JAX finds no GPU.  The full phase
results are written to ``chiprun_out/chip_smoke.json``.

The phase functions take their sizes as arguments, so the CPU tests run
them at tiny sizes with the kernel in the Pallas interpreter.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REF_RES = (1000, 800)  # Config.h:12-13
BOUNCES = 5  # Config.h:19
SPP = 8
GOLDEN_SPP = 64  # scripts/make_golden.py's default
HIGHPOLY_RES = (512, 512)  # bench_suite "highpoly"
GRAD_RES = (256, 200)
REPEATS = 5


def _require(ok, info) -> None:
    """A check that also holds under ``python -O``."""
    if not ok:
        raise AssertionError(info)


def log(name: str, result: dict) -> None:
    print(f"phase {name}: {json.dumps(result, sort_keys=True)}", flush=True)


def _median_time(fn, repeats: int = REPEATS) -> dict:
    """Median and spread of ``repeats`` timed calls after one warm-up;
    ``fn`` returns arrays, each call ends in ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(ts), "min_s": min(ts), "max_s": max(ts)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# checks shared with the GPU-marked tests


def check_bake(scene) -> dict:
    """The world bake on the default device against the same bake on the
    CPU backend.  Compared unsorted (instance order), because rounding may
    order near-equal Morton codes differently on the two backends; whether
    the sorted orders agree is reported."""
    import functools

    import jax
    import numpy as np

    from pathtracerap.ops.plucker import bake_world_triangles

    cpu = jax.devices("cpu")[0]
    unsorted = jax.jit(functools.partial(bake_world_triangles, sort=False))
    dev = unsorted(scene)
    with jax.default_device(cpu):
        host = unsorted(jax.device_put(scene, cpu))
    out = {}
    for name in ("v0", "e1", "e2", "shade_normal", "plane_n", "plane_d"):
        a = np.asarray(getattr(dev, name))
        b = np.asarray(getattr(host, name))
        # rtol 1e-5, plus an absolute floor of 1e-5 of the array's scale:
        # a component that cancels to ~0 (an axis-aligned edge) carries
        # the absolute rounding of its ~1e3-unit inputs, not a relative one
        atol = 1e-5 * float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol, err_msg=name)
        out[name] = float(np.abs(a - b).max())
    sorted_bake = jax.jit(bake_world_triangles)
    with jax.default_device(cpu):
        host_sorted = sorted_bake(jax.device_put(scene, cpu))
    out["sorted_order_identical"] = bool(
        np.array_equal(np.asarray(sorted_bake(scene).tri_model),
                       np.asarray(host_sorted.tri_model))
    )
    return out


def kernel_agreement(world, ro, rd, alive=None) -> dict:
    """Kernel ``nearest_hit`` against the HIGHEST plain sweep on one
    wavefront; only rays that are ``alive`` are compared (a dead lane's
    kernel result is meaningless by contract)."""
    import jax
    import numpy as np

    from pathtracerap.ops.math import normalize
    from pathtracerap.ops.plucker import nearest_mxu
    from pathtracerap.oracle.reference import hits_f64, tied_hits
    from pathtracerap.pallas.trace import nearest_hit

    rd_n = normalize(rd)
    kernel = jax.jit(lambda w, o, d, a: nearest_hit(
        w.tri_pack, w.block_aabb, w.tri_block, o, d, a))
    t_k, i_k = (np.asarray(x) for x in kernel(world, ro, rd_n, alive))
    t_r, i_r = (np.asarray(x) for x in jax.jit(nearest_mxu)(world, ro, rd_n))
    live = np.ones(t_r.shape, bool) if alive is None else np.asarray(alive)
    o = np.asarray(ro, np.float64)[live]
    d = np.asarray(rd_n, np.float64)[live]
    t_k, i_k, t_r, i_r = t_k[live], i_k[live], t_r[live], i_r[live]
    f_max = 9999999.0
    hit_k, hit_r = t_k < f_max, t_r < f_max
    same = (i_k == i_r) | (~hit_k & ~hit_r)
    both = hit_k & hit_r
    rel = np.abs(t_k - t_r) / np.maximum(np.abs(t_r), 1e-30)
    # where the engines pick different triangles, both picks must be
    # equally right in float64 (a ray on an edge two triangles share)
    flip = both & (i_k != i_r)
    tie = np.zeros_like(flip)
    shared = np.zeros_like(flip)
    tie[flip], shared[flip] = tied_hits(world, o[flip], d[flip], i_k[flip], i_r[flip])
    agree = both & (i_k == i_r)
    # both engines' t against a float64 Moeller-Trumbore of the same f32
    # triangle: the Pluecker sides of a small triangle far from the origin
    # cancel (|o x d| |q - p| >> |det|), so each f32 engine alone is off
    # the exact t by up to ~1e-4 relative on a few rays
    t64, _ = hits_f64(o[agree], d[agree], *(
        np.asarray(getattr(world, k))[i_k[agree]] for k in ("v0", "e1", "e2")))
    err = lambda t: np.abs(t[agree] - t64) / np.maximum(np.abs(t64), 1e-30)
    n = max(int(live.sum()), 1)
    m = max(int(agree.sum()), 1)
    return {
        "rays": int(live.sum()),
        "hit_fraction": float(hit_r.sum()) / n,
        "hit_mask_mismatches": int((hit_k != hit_r).sum()),
        "index_agreement": float(same.sum()) / n,
        "index_mismatches": int(flip.sum()),
        "rounding_ties": int(tie.sum()),
        "ties_sharing_a_vertex": int((tie & shared).sum()),
        "index_agreement_with_ties": float((same | tie).sum()) / n,
        "t_max_rel_err": float(rel[agree].max(initial=0.0)),
        "t_share_over_rtol_1e-5": float((rel[agree] > 1e-5).sum()) / m,
        "kernel_vs_f64_share_over_1e-5": float((err(t_k) > 1e-5).sum()) / m,
        "mxu_vs_f64_share_over_1e-5": float((err(t_r) > 1e-5).sum()) / m,
        "kernel_vs_f64_max": float(err(t_k).max(initial=0.0)),
        "mxu_vs_f64_max": float(err(t_r).max(initial=0.0)),
    }


def assert_kernel_agreement(stats: dict) -> None:
    """The kernel's contract with the plain sweep: identical hit/miss
    masks; the same triangle on >= 99.99% of rays, counting as agreement
    only the rounding ties that float64 confirms (``oracle.tied_hits``:
    both picks hit at the same distance, on a shared edge); and, where the
    indices agree, t as accurate as the plain sweep's.  That last is
    judged against a float64 evaluation, not as rtol 1e-5 between the two
    f32 engines: a grazing ray or a small far triangle makes t a quotient
    of cancelling sums, which each engine rounds differently (measured on
    the H100: up to 1.2e-4 relative on 0.08% of the reference scene's
    primaries, and 4e-2 on a secondary ray spawned 0.1 units from a
    surface, where both engines are 0.18 relative off the float64
    value)."""
    _require(stats["hit_mask_mismatches"] == 0, stats)
    _require(stats["index_agreement_with_ties"] >= 0.9999, stats)
    _require(stats["kernel_vs_f64_share_over_1e-5"] <= max(
        1.5 * stats["mxu_vs_f64_share_over_1e-5"], 1e-4), stats)
    _require(stats["kernel_vs_f64_max"] <= max(2.0 * stats["mxu_vs_f64_max"], 1e-5), stats)


def secondary_wavefront(world, ro, rd, key):
    """Origins, directions and liveness of the first secondary bounce."""
    import jax

    from pathtracerap.ops.plucker import trace_mxu
    from pathtracerap.ops.rng import tile_uniforms
    from pathtracerap.render.shade import RayState, shade

    def step(ro, rd):
        state = RayState.primary(ro, rd, BOUNCES)
        u = tile_uniforms(key, 0, BOUNCES, 0, ro.shape[0])
        st = shade(state, trace_mxu(world, ro, rd), u)
        return st.orig, st.dir, st.remaining > 0

    return jax.jit(step)(ro, rd)


# --------------------------------------------------------------------------
# phases


def phase_device() -> dict:
    import jax

    d = jax.devices()
    return {
        "platform": d[0].platform,
        "device_kind": d[0].device_kind,
        "count": len(d),
        "nvidia_smi": card_line(),
        "jax": jax.__version__,
    }


def phase_kernel(ref_scene, hp_scene, ref_res=REF_RES, hp_res=HIGHPOLY_RES) -> dict:
    """The kernel against the plain sweep: the full primary wavefront and
    one secondary wavefront of the reference scene, and highpoly primaries.
    Also compiles the kernel at the main path's per-call width (8192 rays)
    and reports the compile time."""
    import jax

    from pathtracerap.config import RenderConfig
    from pathtracerap.ops.math import normalize
    from pathtracerap.ops.plucker import bake_world_triangles
    from pathtracerap.pallas.trace import nearest_hit
    from pathtracerap.render.camera import generate_rays
    from pathtracerap.bench_suite import _ROOM_CAMERA

    out = {}
    world = jax.jit(bake_world_triangles)(ref_scene)
    ro, rd = generate_rays(RenderConfig().camera, ref_res)
    n_call = min(8192, ro.shape[0])
    t0 = time.perf_counter()
    jax.jit(lambda w, o, d: nearest_hit(
        w.tri_pack, w.block_aabb, w.tri_block, o, d)).lower(
        world, ro[:n_call], normalize(rd[:n_call])).compile()
    out["compile_s_per_call_kernel"] = time.perf_counter() - t0
    out["reference_triangles"] = int(world.n_valid)
    out["reference_blocks"] = int(world.block_aabb.shape[0])

    stats = kernel_agreement(world, ro, rd)
    assert_kernel_agreement(stats)
    out["reference_primary"] = stats
    ro2, rd2, alive2 = secondary_wavefront(world, ro, rd, jax.random.PRNGKey(0))
    stats = kernel_agreement(world, ro2, rd2, alive2)
    assert_kernel_agreement(stats)
    out["reference_secondary"] = stats

    hp_world = jax.jit(bake_world_triangles)(hp_scene)
    ro_h, rd_h = generate_rays(_ROOM_CAMERA, hp_res)
    stats = kernel_agreement(hp_world, ro_h, rd_h)
    assert_kernel_agreement(stats)
    out["highpoly_primary"] = stats
    out["highpoly_triangles"] = int(hp_world.n_valid)
    out["highpoly_blocks"] = int(hp_world.block_aabb.shape[0])
    return out


def _image_agreement(a, b) -> dict:
    import numpy as np

    d = np.abs(np.asarray(a) - np.asarray(b))
    return {
        "mean_abs_diff": float(d.mean()),
        "pixels_within_1_255": float((d.max(axis=-1) <= 1.0 / 255.0).mean()),
    }


def _down(x, f):
    h, w, _ = x.shape
    return x[: h - h % f, : w - w % f].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))


def golden_agreement(image, golden_path: str) -> dict:
    """Downsampled comparison with a committed golden at the bounds
    tests/test_reference_golden.py holds full-size renders to."""
    import numpy as np

    from pathtracerap.io.bmp import read_bmp

    ours = np.asarray(image)
    gold = read_bmp(golden_path).astype(np.float32) / 255.0
    _require(ours.shape == gold.shape, (ours.shape, gold.shape))
    a, b = _down(ours, 8), _down(gold, 8)
    out = {
        "mad": float(np.abs(a - b).mean()),
        "corr": float(np.corrcoef(a.ravel(), b.ravel())[0, 1]),
        "channel_drift": float(np.abs(ours.mean(axis=(0, 1)) - gold.mean(axis=(0, 1))).max()),
    }
    _require(out["mad"] < 0.025 and out["corr"] > 0.99 and out["channel_drift"] < 0.008, out)
    return out


def phase_forward(scene, res=REF_RES, spp=SPP, golden_spp=GOLDEN_SPP,
                  golden_path: str | None = None) -> dict:
    """``Renderer.render`` on the chosen engine against a HIGHEST ``mxu``
    render of the same config and seed; the golden's config against the
    committed golden; compiled memory and peak device memory."""
    import jax
    import numpy as np

    from pathtracerap.config import RenderConfig
    from pathtracerap.render.wavefront import Renderer, render_accumulate

    cfg = RenderConfig(resolution=res, samples_per_pixel=spp, max_bounces=BOUNCES)
    r = Renderer(scene, cfg)
    out = {"engine": r.engine}
    t0 = time.perf_counter()
    img = r.render().block_until_ready()
    out["first_render_s"] = time.perf_counter() - t0
    ref = Renderer(scene, RenderConfig(resolution=res, samples_per_pixel=spp,
                                       max_bounces=BOUNCES, engine="mxu")).render()
    agree = _image_agreement(img, ref)
    _require(agree["mean_abs_diff"] <= 1e-4 and agree["pixels_within_1_255"] >= 0.999, agree)
    out["vs_mxu"] = agree
    _require(np.isfinite(np.asarray(img)).all(), "non-finite image")

    compiled = render_accumulate.lower(
        scene, jax.random.PRNGKey(cfg.seed), cfg.camera, cfg.resolution,
        n_samples=spp, max_bounces=BOUNCES, engine=r.engine, world=r.world,
    ).compile()
    mem = compiled.memory_analysis()
    if mem is not None:
        out["compiled_memory"] = {
            k: int(getattr(mem, k)) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(mem, k)
        }
    if golden_path is not None:
        gcfg = RenderConfig(resolution=res, samples_per_pixel=golden_spp,
                            max_bounces=BOUNCES)
        gimg = Renderer(scene, gcfg).render()
        out["golden"] = golden_agreement(gimg, golden_path)
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    return out


def phase_train(scene, res=REF_RES, grad_res=GRAD_RES, steps: int = 3,
                n_samples: int = 2) -> dict:
    """``make_train_step`` in quality mode on material colors and on
    material colors + vertex positions: the loss stays finite over a few
    steps; at ``grad_res`` the gradients match the ``mxu`` engine's."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pathtracerap.config import RenderConfig
    from pathtracerap.diff.grad import extract_params, image_loss, make_train_step

    cam = RenderConfig().camera
    out = {}
    key = jax.random.PRNGKey(0)
    for names in (("mat_color",), ("mat_color", "vertex_pos")):
        tag = "+".join(names)
        step = make_train_step(scene, cam, res, n_samples, BOUNCES, parity=False,
                               tile_size=8192)
        params = extract_params(scene, names)
        target = jnp.full((res[0] * res[1], 3), 0.5, jnp.float32)
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, params = step(params, target, key)
            losses.append(float(loss))
        out[tag] = {"losses": losses, "wall_s": time.perf_counter() - t0}
        _require(all(np.isfinite(losses)), (tag, losses))

    names = ("mat_color", "vertex_pos")
    params = extract_params(scene, names)
    target = jnp.full((grad_res[0] * grad_res[1], 3), 0.5, jnp.float32)

    def grads(engine):
        f = lambda p: image_loss(p, scene, target, key, cam, grad_res, n_samples,
                                 BOUNCES, tile_size=8192, engine=engine, parity=False)
        return jax.jit(jax.grad(f))(params)

    g_k, g_m = grads("auto"), grads("mxu")
    out["grads_vs_mxu"] = {}
    for k in names:
        a, b = np.asarray(g_k[k]).ravel(), np.asarray(g_m[k]).ravel()
        # rtol 1e-3 with an absolute floor of 1e-3 of the largest entry
        # (entries near 0 carry the cancellation of sums taken in another
        # order).  Material colours must meet it everywhere.  Vertex
        # gradients are sparse (few rays per vertex at this size), and a
        # ray on the edge two triangles share may pick the other triangle
        # of the pair (a rounding tie, see assert_kernel_agreement), which
        # moves its gradient to other vertices: there the check is on the
        # share of entries off and on the direction of the whole gradient.
        off = ~np.isclose(a, b, rtol=1e-3, atol=1e-3 * float(np.abs(b).max()))
        cos = float(a @ b / max(float(np.linalg.norm(a) * np.linalg.norm(b)), 1e-30))
        stats = {"entries_off": int(off.sum()), "share_off": float(off.mean()),
                 "cosine": cos,
                 "rel_l2": float(np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), 1e-30))}
        out["grads_vs_mxu"][k] = stats
        if k == "mat_color":
            _require(stats["entries_off"] == 0, (k, stats))
        else:
            _require(stats["share_off"] <= 0.01 and cos >= 0.99, (k, stats))
    return out


def phase_timings(ref_scene, hp_scene, ref_res=REF_RES, hp_res=HIGHPOLY_RES,
                  spp: int = SPP, repeats: int = REPEATS,
                  tiles=(("pallas", (8192, 65536, 262144)),
                         ("mxu", (8192, 65536)))) -> dict:
    """Kernel against the plain sweep per traversal call (8192 rays, the
    main path's per-call shape, and a full wavefront) on the reference
    scene and highpoly, then end to end through ``Renderer.render`` on
    both engines (each at its default tile), and on each engine at the
    render tile sizes ``tiles`` gives it."""
    import jax

    from pathtracerap.bench_suite import _ROOM_CAMERA
    from pathtracerap.config import RenderConfig
    from pathtracerap.ops.math import normalize
    from pathtracerap.ops.plucker import bake_world_triangles, nearest_mxu
    from pathtracerap.pallas.trace import nearest_hit
    from pathtracerap.render.camera import generate_rays
    from pathtracerap.render.wavefront import Renderer, render_accumulate

    out = {}
    kernel = jax.jit(lambda w, o, d: nearest_hit(
        w.tri_pack, w.block_aabb, w.tri_block, o, d))
    plain = jax.jit(nearest_mxu)
    for name, scene, cam, res in (("reference", ref_scene, RenderConfig().camera, ref_res),
                                  ("highpoly", hp_scene, _ROOM_CAMERA, hp_res)):
        world = jax.jit(bake_world_triangles)(scene)
        ro, rd = generate_rays(cam, res)
        rd = normalize(rd)
        for tag, n in (("call_8192", min(8192, ro.shape[0])), ("wavefront", ro.shape[0])):
            o, d = ro[:n], rd[:n]
            out[f"{name}_{tag}"] = {
                "rays": int(n),
                "kernel": _median_time(lambda: kernel(world, o, d), repeats),
                "mxu": _median_time(lambda: plain(world, o, d), repeats),
            }

    cfg = dict(resolution=ref_res, samples_per_pixel=spp, max_bounces=BOUNCES)
    for engine in ("pallas", "mxu"):
        r = Renderer(ref_scene, RenderConfig(engine=engine, **cfg))
        t = _median_time(r.render, repeats)
        t["mrays_per_s"] = ref_res[0] * ref_res[1] * spp * BOUNCES / t["median_s"] / 1e6
        out[f"render_{engine}"] = t
    world = jax.jit(bake_world_triangles)(ref_scene)
    key = jax.random.PRNGKey(0)
    for engine, sizes in tiles:
        for tile in sizes:
            f = lambda engine=engine, tile=tile: render_accumulate(
                ref_scene, key, RenderConfig().camera, ref_res, n_samples=spp,
                max_bounces=BOUNCES, engine=engine, world=world, tile_size=tile)
            out[f"render_{engine}_tile_{tile}"] = _median_time(f, repeats)
    return out


def phase_four_cards(scene, res=(1000, 800), spp: int = 2, grad_res=GRAD_RES,
                     ring_res=GRAD_RES, tile: int = 8192) -> dict:
    """What exists only across cards, each against its one-card result:
    the DP render (``render_image_dp``), one sharded train step
    (``make_sharded_train_step``) and the geometry ring render."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pathtracerap.config import RenderConfig
    from pathtracerap.diff.grad import extract_params, image_loss, make_sharded_train_step
    from pathtracerap.parallel.geometry import render_image_geometry_sharded
    from pathtracerap.parallel.sharding import default_mesh, render_image_dp
    from jax.sharding import Mesh

    out = {"devices": len(jax.devices())}
    mesh = default_mesh()
    cfg = RenderConfig(resolution=res, samples_per_pixel=spp, max_bounces=BOUNCES)
    t0 = time.perf_counter()
    img_dp = np.asarray(render_image_dp(scene, cfg, mesh=mesh, tile_size=tile))
    out["dp_render_first_s"] = time.perf_counter() - t0
    img_1 = np.asarray(render_image_dp(scene, cfg, mesh=default_mesh(1), tile_size=tile))
    np.testing.assert_allclose(img_dp, img_1, rtol=1e-6, atol=1e-6)
    out["dp_render_max_abs_diff"] = float(np.abs(img_dp - img_1).max())

    cam = cfg.camera
    key = jax.random.PRNGKey(0)
    names = ("mat_color", "vertex_pos")
    params = extract_params(scene, names)
    n = grad_res[0] * grad_res[1]
    target = jnp.full((n, 3), 0.5, jnp.float32)
    lr = 0.05
    step = make_sharded_train_step(scene, cam, grad_res, 2, BOUNCES, mesh, lr=lr,
                                   tile_size=tile, parity=False)
    loss, new = step(params, target, key)

    def sum_loss(p):
        return image_loss(p, scene, target, key, cam, grad_res, 2, BOUNCES,
                          tile_size=tile, reduce="sum", parity=False)

    loss1, g1 = jax.jit(jax.value_and_grad(sum_loss))(params)
    np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-5)
    for k in names:
        want = np.asarray(params[k] - lr * g1[k])
        np.testing.assert_allclose(np.asarray(new[k]), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(lr * np.asarray(g1[k])).max()),
                                   err_msg=k)
    out["train_step_loss"] = [float(loss), float(loss1)]

    rcfg = RenderConfig(resolution=ring_res, samples_per_pixel=spp, max_bounces=BOUNCES)
    ring = np.asarray(render_image_geometry_sharded(
        scene, rcfg, mesh=Mesh(mesh.devices, ("shard",)), tile_size=tile))
    rep = np.asarray(render_image_dp(scene, rcfg, mesh=mesh, tile_size=tile))
    np.testing.assert_allclose(ring, rep, atol=1e-5)
    out["ring_max_abs_diff"] = float(np.abs(ring - rep).max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    try:
        import jax
    except ImportError as e:
        sys.exit(f"chip_smoke: cannot import jax: {e}")
    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"chip_smoke: needs an NVIDIA GPU, JAX found {platform!r}")
    try:
        import pathtracerap  # noqa: F401
    except ImportError as e:
        sys.exit(f"chip_smoke: run from the repository root ({e})")

    from pathtracerap.bench_suite import build_highpoly_scene
    from pathtracerap.scene.build import build_reference_scene
    from pathtracerap.utils.profiling import enable_compile_cache

    enable_compile_cache()
    results = {}

    def run(name, fn, *a, **kw):
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        res["phase_s"] = time.perf_counter() - t0
        results[name] = res
        log(name, res)

    run("device", phase_device)
    ref = build_reference_scene().to_device()
    if args.four_cards:
        _require(len(jax.devices()) == 4, jax.devices())
        run("four_cards", phase_four_cards, ref)
    else:
        hp = build_highpoly_scene().to_device()
        golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "assets", "golden", "reference_scene.bmp")
        run("bake", check_bake, ref)
        run("kernel", phase_kernel, ref, hp)
        run("forward", phase_forward, ref, golden_path=golden)
        run("train", phase_train, ref)
        run("timings", phase_timings, ref, hp)

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    print(results["device"]["nvidia_smi"], flush=True)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
