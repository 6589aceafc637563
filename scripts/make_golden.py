"""Render the reference scene at full resolution and compare against the
reference's committed Render.bmp; write the repo's golden.

Usage: python scripts/make_golden.py [spp] [engine] [reference_render_bmp]
Writes assets/golden/reference_scene.bmp; given the reference's
Render.bmp, prints similarity stats against it.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import functools
import time

import numpy as np

print = functools.partial(print, flush=True)

spp = int(sys.argv[1]) if len(sys.argv) > 1 else 64
engine = sys.argv[2] if len(sys.argv) > 2 else "auto"

from pathtracerap.config import RenderConfig
from pathtracerap.io.bmp import quantize_image, read_bmp, write_bmp
from pathtracerap.render.wavefront import Renderer
from pathtracerap.scene.build import build_reference_scene
from pathtracerap.utils.profiling import enable_compile_cache

enable_compile_cache()

cfg = RenderConfig(
    resolution=(1000, 800), samples_per_pixel=spp, max_bounces=5,
    engine=engine, samples_per_chunk=min(spp, 32),
)
r = Renderer(build_reference_scene().to_device(), cfg)
t0 = time.perf_counter()
img = np.asarray(r.render())
print(f"rendered 1000x800 @ {spp}spp ({engine}) in {time.perf_counter()-t0:.1f}s")

os.makedirs(os.path.join(ROOT, "assets", "golden"), exist_ok=True)
out_path = os.path.join(ROOT, "assets", "golden", "reference_scene.bmp")
accum = img * spp
write_bmp(out_path, quantize_image(accum, spp))
print("wrote", out_path)

ref_path = sys.argv[3] if len(sys.argv) > 3 else ""
if ref_path and os.path.exists(ref_path):
    ours = read_bmp(out_path).astype(np.float32) / 255.0
    ref = read_bmp(ref_path).astype(np.float32) / 255.0
    print("shapes:", ours.shape, ref.shape)

    def down(x, f=8):
        h, w, _ = x.shape
        return x[: h - h % f, : w - w % f].reshape(h // f, f, w // f, f, 3).mean(
            axis=(1, 3)
        )

    d_ours, d_ref = down(ours), down(ref)
    mad = np.abs(d_ours - d_ref).mean()
    corr = np.corrcoef(d_ours.ravel(), d_ref.ravel())[0, 1]
    print(f"downsampled 8x: mean|diff|={mad:.4f}  corr={corr:.4f}")
    print(f"means: ours={ours.mean():.4f} ref={ref.mean():.4f}")
    # per-channel means to catch channel swaps
    print("channel means ours:", ours.mean(axis=(0, 1)))
    print("channel means ref :", ref.mean(axis=(0, 1)))
