"""Runtime configuration.

The reference has no runtime configuration at all: every knob is a
compile-time ``#define`` (``Config.h:4-19``), the scene is hard-coded C++
(``Scene.cpp:6-223``) and the camera lives inside a kernel
(``Renderer.cpp:528-543``).  This module is the config layer the reference
lacks: plain dataclasses, serializable to/from dicts (and JSON), that fully
describe a render.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

from . import constants


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera shooting through an axis-aligned image-plane rectangle.

    Defaults reproduce the reference camera exactly: eye at (0, 0, 920)
    looking down -z through the rectangle x in [-10, 10), y in [-4, 12) at
    z = 900 (``Renderer.cpp:528-545``).  Rows are generated bottom-up
    (y index 0 = bottom of the image), matching the BMP writer's bottom-up
    row order (``Renderer.cpp:45-53``).
    """

    position: Tuple[float, float, float] = (0.0, 0.0, 920.0)
    plane_x: Tuple[float, float] = (-10.0, 10.0)
    plane_y: Tuple[float, float] = (-4.0, 12.0)
    plane_z: float = 900.0
    # When True, add stratified sub-pixel jitter per sample.  The reference
    # has no jitter — every iteration shoots the identical primary ray
    # (Renderer.cpp:538-545) — so parity mode keeps this False.
    jitter: bool = False


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Full description of one render job."""

    resolution: Tuple[int, int] = (constants.RESOLUTION_X, constants.RESOLUTION_Y)
    samples_per_pixel: int = constants.ITER
    max_bounces: int = constants.MAX_BOUNCES
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)

    # Traversal engine: "parity" (reference-faithful vectorized DDA),
    # "mxu" (Pluecker sweep as XLA products), "pallas" (the fused
    # Pluecker nearest-hit kernel, GPU only), or "auto" (the backend's
    # fast engine: "pallas" on the GPU, "mxu" elsewhere).
    engine: str = "auto"

    # parity=True reproduces the reference's behavioral quirks exactly
    # (quirky reflectRay formula utility.h:64-69, DDA early-exit
    # Renderer.cpp:326-329, no-jitter camera).  parity=False enables the
    # physically standard alternatives.
    parity: bool = True

    # Uniform-grid resolution used when building acceleration structures.
    grid_dims: Tuple[int, int, int] = (constants.GRID_X, constants.GRID_Y, constants.GRID_Z)

    # Cache the first-bounce intersection across samples.  Valid whenever
    # primary rays are deterministic (no jitter); mirrors the reference's
    # first-intersection cache (Renderer.cpp:594-613).
    cache_first_hit: bool = True

    # Accumulation dtype for the image sum.
    accum_dtype: str = "float32"

    # Number of samples folded into a single jitted device step.  The sample
    # loop runs as lax.fori_loop inside jit; checkpoints (if enabled) happen
    # between chunks of this size.
    samples_per_chunk: int = 0  # 0 = all samples in one jit call

    seed: int = 0

    def to_dict(self) -> dict:
        # JSON-canonical (tuples -> lists) so round-trips compare equal
        return json.loads(json.dumps(dataclasses.asdict(self)))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "RenderConfig":
        d = dict(d)
        cam = d.pop("camera", None)
        cfg = cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})
        if cam is not None:
            cam = {k: tuple(v) if isinstance(v, list) else v for k, v in cam.items()}
            cfg = dataclasses.replace(cfg, camera=CameraConfig(**cam))
        return cfg

    @classmethod
    def from_json(cls, s: str) -> "RenderConfig":
        return cls.from_dict(json.loads(s))

    @property
    def n_pixels(self) -> int:
        return self.resolution[0] * self.resolution[1]
