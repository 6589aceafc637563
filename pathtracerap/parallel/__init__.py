from .distributed import comm_model, init_distributed, scaling_report
from .geometry import (
    make_geometry_sharded_tracer,
    make_geometry_sharded_train_step,
    make_ring_diff_tracer,
    render_image_geometry_sharded,
)
from .sharding import (
    default_mesh,
    render_accumulate_dp,
    render_image_dp,
)

__all__ = [
    "comm_model",
    "default_mesh",
    "init_distributed",
    "make_geometry_sharded_tracer",
    "make_geometry_sharded_train_step",
    "make_ring_diff_tracer",
    "render_accumulate_dp",
    "render_image_dp",
    "render_image_geometry_sharded",
    "scaling_report",
]
