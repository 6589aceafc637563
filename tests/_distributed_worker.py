"""Worker process for the REAL multi-process distributed test.

Launched by ``tests/test_distributed.py::test_two_process_distributed``:
two of these processes (4 fake CPU devices each) form one 8-device JAX
job via ``jax.distributed.initialize`` (the code path
``parallel/distributed.init_distributed`` exists for) and run a sharded
train step + a sample-parallel render over the GLOBAL mesh — collectives
cross the process boundary over the gRPC coordinator as they would cross
the network between hosts.
"""

import json
import os
import sys


def main() -> None:
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    out_path = sys.argv[4]

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from pathtracerap.pallas.trace import interpret_mode

    with interpret_mode():  # the kernel runs in the Pallas interpreter on CPU
        _run(pid, nproc, port, out_path)


def _run(pid: int, nproc: int, port: str, out_path: str) -> None:
    import jax
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from pathtracerap.config import CameraConfig
    from pathtracerap.diff.grad import extract_params, make_sharded_train_step
    from pathtracerap.ops.plucker import bake_world_triangles
    from pathtracerap.parallel.distributed import init_distributed
    from pathtracerap.parallel.sharding import (
        render_accumulate_sample_parallel,
    )
    from pathtracerap.scene.build import build_cornell_box_scene

    info = init_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert info["initialized_multiprocess"], info
    assert info["process_count"] == nproc, info
    assert info["local_devices"] == 4, info
    assert info["global_devices"] == 4 * nproc, info

    camera = CameraConfig(
        position=(0.0, 0.0, 150.0),
        plane_x=(-40.0, 40.0),
        plane_y=(-30.0, 30.0),
        plane_z=100.0,
    )
    scene = build_cornell_box_scene().to_device()
    res = (32, 16)
    n = res[0] * res[1]
    mesh = Mesh(np.asarray(jax.devices()), ("rays",))

    # sharded train step over the global mesh: the psum of loss/grads is a
    # cross-process collective; outputs are replicated (P()) and therefore
    # fully addressable on every process
    step = make_sharded_train_step(
        scene, camera, res, n_samples=2, max_bounces=3, mesh=mesh,
        tile_size=32, engine="pallas",
    )
    params = extract_params(scene, ("mat_color",))
    key = jax.random.PRNGKey(3)
    target = jnp.full((n, 3), 0.25, jnp.float32)
    loss, new_params = step(params, target, key)

    # sample-parallel render: per-device sample slices merged by one psum
    # across the global mesh; output replicated
    world = jax.jit(bake_world_triangles)(scene)
    acc = render_accumulate_sample_parallel(
        scene, key, camera, res, n_samples=8, max_bounces=3, mesh=mesh,
        engine="mxu", world=world,
    )

    result = {
        "info": info,
        "loss": float(loss),
        "mat_color": np.asarray(new_params["mat_color"]).tolist(),
        "render_mean": float(jnp.mean(acc)),
    }
    if pid == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
