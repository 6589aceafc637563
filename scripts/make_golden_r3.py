"""Round-3 goldens:

1. assets/golden/diffuse_reference.bmp — the diffuse-monkeys scene
   (scenes/diffuse_reference.scn) at full resolution.
2. assets/golden/reference_scene_parity.bmp — the reference scene rendered
   by the PARITY engine (per-ray DDA with the reference's quirks) for the
   cross-check that the DDA engine agrees with the soup engines at the
   scene that motivated the quirks (r2 VERDICT weak item 7).

Usage: python scripts/make_golden_r3.py [diffuse_spp] [parity_spp]
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import functools
import time

import numpy as np

print = functools.partial(print, flush=True)

diffuse_spp = int(sys.argv[1]) if len(sys.argv) > 1 else 64
parity_spp = int(sys.argv[2]) if len(sys.argv) > 2 else 4

from pathtracerap.config import RenderConfig
from pathtracerap.io.bmp import quantize_image, read_bmp, write_bmp
from pathtracerap.render.wavefront import Renderer
from pathtracerap.scene.build import build_reference_scene
from pathtracerap.scene.dsl import load_scene_file, render_config_from_parsed
from pathtracerap.utils.profiling import enable_compile_cache

enable_compile_cache()
os.makedirs(os.path.join(ROOT, "assets", "golden"), exist_ok=True)


def down(x, f=8):
    h, w, _ = x.shape
    return x[: h - h % f, : w - w % f].reshape(h // f, f, w // f, f, 3).mean(
        axis=(1, 3)
    )


# ---- 1. diffuse scene golden (the backend's fast engine)
p = load_scene_file(os.path.join(ROOT, "scenes", "diffuse_reference.scn"))
cfg = render_config_from_parsed(
    p, samples_per_pixel=diffuse_spp, engine="auto",
    samples_per_chunk=min(diffuse_spp, 32),
)
t0 = time.perf_counter()
img = np.asarray(Renderer(p.scene.to_device(), cfg).render())
print(f"diffuse render {cfg.resolution} @ {diffuse_spp}spp in "
      f"{time.perf_counter()-t0:.1f}s  mean={img.mean():.4f}")
out = os.path.join(ROOT, "assets", "golden", "diffuse_reference.bmp")
write_bmp(out, quantize_image(img * diffuse_spp, diffuse_spp))
print("wrote", out)

# ---- 2. parity-engine render of the reference scene
cfg_p = RenderConfig(
    resolution=(1000, 800), samples_per_pixel=parity_spp, max_bounces=5,
    engine="parity", samples_per_chunk=min(parity_spp, 4),
)
t0 = time.perf_counter()
img_p = np.asarray(Renderer(build_reference_scene().to_device(), cfg_p).render())
print(f"parity render 1000x800 @ {parity_spp}spp in "
      f"{time.perf_counter()-t0:.1f}s  mean={img_p.mean():.4f}")
out_p = os.path.join(ROOT, "assets", "golden", "reference_scene_parity.bmp")
write_bmp(out_p, quantize_image(img_p * parity_spp, parity_spp))
print("wrote", out_p)

# cross-check vs the committed soup-engine golden
g = read_bmp(os.path.join(ROOT, "assets", "golden", "reference_scene.bmp")).astype(np.float32) / 255.0
q = read_bmp(out_p).astype(np.float32) / 255.0
mad = float(np.abs(down(q) - down(g)).mean())
corr = float(np.corrcoef(down(q).ravel(), down(g).ravel())[0, 1])
print(f"parity-vs-soup golden: downsampled mean|diff|={mad:.4f} corr={corr:.4f}")
