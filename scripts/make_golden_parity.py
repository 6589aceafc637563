"""Parity-engine (per-ray DDA) full-res render of the reference scene —
the cross-check of the committed soup-engine golden.

The image renders in row bands — one dispatch per band, which keeps each
dispatch short (the DDA while_loops wait for the slowest lane) — with the
global RNG tile numbering preserved via ``tile_base``.

Usage: python scripts/make_golden_parity.py [spp] [tile] [band_rows]
"""
import functools
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax
import numpy as np

print = functools.partial(print, flush=True)

spp = int(sys.argv[1]) if len(sys.argv) > 1 else 4
tile = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
band_rows = int(sys.argv[3]) if len(sys.argv) > 3 else 50

from pathtracerap.config import RenderConfig
from pathtracerap.io.bmp import quantize_image, read_bmp, write_bmp
from pathtracerap.render.camera import generate_rays
from pathtracerap.render.wavefront import (
    _make_tracer,
    _render_tile,
    render_ray_array,
)
from pathtracerap.scene.build import build_reference_scene
from pathtracerap.utils.profiling import enable_compile_cache

enable_compile_cache()

cfg = RenderConfig(resolution=(1000, 800), samples_per_pixel=spp,
                   max_bounces=5, engine="parity")
scene = build_reference_scene().to_device()
key = jax.random.PRNGKey(cfg.seed)
w, h = cfg.resolution
ro, rd = generate_rays(cfg.camera, cfg.resolution)
band = band_rows * w
assert band % tile == 0, (band, tile)

tracer = _make_tracer(scene, "parity")
render_tile = functools.partial(
    _render_tile, tracer, key=key, n_samples=spp, max_bounces=cfg.max_bounces,
    parity=True, sample_offset=0, scene=scene,
)


@jax.jit
def render_band(ro_b, rd_b, base):
    return render_ray_array(render_tile, ro_b, rd_b, tile, tile_base=base)


parts = []
for s in range(0, w * h, band):
    t0 = time.perf_counter()
    part = np.asarray(render_band(ro[s:s + band], rd[s:s + band], s // tile))
    parts.append(part)
    print(f"rows {s // w}-{(s + band) // w}: {time.perf_counter()-t0:.1f}s "
          f"mean={part.mean()/spp:.4f}")

acc = np.concatenate(parts, axis=0)
out = os.path.join(ROOT, "assets", "golden", "reference_scene_parity.bmp")
write_bmp(out, quantize_image(acc.reshape(h, w, 3), spp))
print("wrote", out)

g = read_bmp(os.path.join(ROOT, "assets", "golden", "reference_scene.bmp")).astype(np.float32) / 255.0
q = read_bmp(out).astype(np.float32) / 255.0


def down(x, f=8):
    hh, ww, _ = x.shape
    return x[: hh - hh % f, : ww - ww % f].reshape(hh // f, f, ww // f, f, 3).mean(
        axis=(1, 3)
    )


mad = float(np.abs(down(q) - down(g)).mean())
corr = float(np.corrcoef(down(q).ravel(), down(g).ravel())[0, 1])
print(f"parity-vs-soup golden: downsampled mean|diff|={mad:.4f} corr={corr:.4f}")
