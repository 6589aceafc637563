"""pathtracerap — a differentiable wavefront path tracer for the GPU.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the CUDA
reference renderer PathTracerAP (see SURVEY.md for the structural analysis):
wavefront path tracing over uniform-grid-accelerated triangle scenes with
DIFFUSE / METAL / COAT / REFLECTIVE / EMISSIVE materials, OBJ import, BMP
output — plus the capabilities the reference lacks: differentiability
(pixel gradients to materials, lights, vertices), multi-device sharding, a
config/CLI layer, metrics, checkpointing and tests.
"""

__version__ = "0.1.0"

from . import constants
from .config import CameraConfig, RenderConfig

__all__ = ["constants", "CameraConfig", "RenderConfig", "__version__"]
