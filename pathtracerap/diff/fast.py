"""Differentiable fast-path traversal: kernel forward, recompute backward.

The fastest traversal engine (the Pallas kernel) and the differentiable
engine (the XLA Pluecker sweep) are different code paths.  This module
unifies them with the detached-topology estimator the framework already
uses everywhere:

* the **discrete** part of traversal — which triangle is nearest — comes
  from the kernel under ``stop_gradient`` (no backward cost at all);
* the **continuous** hit quantities (t, shading normal, material color) are
  recomputed differentiably at the frozen argmin index from the baked
  ``WorldTriangles.v0/e1/e2`` (carried for exactly this,
  ``scene/types.py``) via closed-form Moeller-Trumbore — algebraically the
  same distance the kernel computed (Renderer.cpp:174-215), so forward
  values agree to fp roundoff while gradients flow to vertex positions,
  model transforms and material colors through the bake.

This is equivalent to a ``jax.custom_vjp`` whose forward calls the kernel
and whose backward differentiates the recompute — expressed with
``stop_gradient`` + re-evaluation instead, which composes with ``vmap`` /
``shard_map`` / higher-order AD for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import constants
from ..ops.intersect import HitRecord
from ..ops.math import normalize, normalize_guarded
from ..scene.types import WorldTriangles

F_MAX = constants.FLOAT_MAX


def hit_from_index(
    world: WorldTriangles, ro: jax.Array, rd_n: jax.Array, idx: jax.Array,
    hit: jax.Array,
) -> HitRecord:
    """Differentiable hit quantities at a frozen triangle index.

    Moeller-Trumbore with the triangle's (v0, e1, e2); ``hit`` masks lanes
    whose kernel trace missed (their values are the miss sentinels, whose
    gradient is zero by construction of the ``where``)."""
    # ONE fused gather for all four geometry tables: its backward is one
    # scatter-add of an (N, 12) cotangent instead of four of (N, 3) ones
    geo = jnp.concatenate(
        [world.v0, world.e1, world.e2, world.shade_normal], axis=1
    )  # (T, 12)
    rows = geo[idx]
    v0 = rows[:, 0:3]
    e1 = rows[:, 3:6]
    e2 = rows[:, 6:9]
    nsh = rows[:, 9:12]
    pvec = jnp.cross(rd_n, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    safe = jnp.where(det == 0.0, 1.0, det)
    tvec = ro - v0
    qvec = jnp.cross(tvec, e1)
    t = jnp.sum(e2 * qvec, axis=-1) / safe

    if world.mat_table is not None:
        # material color via a one-hot product over the model slots: the
        # VJP is ``one_hot.T @ g`` — one small product per bounce — instead
        # of a per-ray scatter-add into the (T, 3) table.  HIGHEST keeps
        # the colors exact in f32 (a one-hot row selects one entry).
        # Forward-identical: world.mat_color == mat_table[tri_model].
        slot = jax.lax.stop_gradient(world.tri_model[idx])
        onehot = jax.nn.one_hot(
            slot, world.mat_table.shape[0], dtype=jnp.float32
        )
        mat_color = jnp.dot(
            onehot, world.mat_table, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    else:
        mat_color = world.mat_color[idx]

    return HitRecord(
        t=jnp.where(hit, t, F_MAX),
        normal=jnp.where(hit[:, None], nsh, 0.0),
        mat_type=jnp.where(hit, world.mat_type[idx], 0),
        mat_color=jnp.where(hit[:, None], mat_color, 0.0),
        # geometric normal straight from positions — the quality-mode
        # cosine factor's vertex-gradient carrier (render/shade.py)
        geom_normal=jnp.where(
            hit[:, None], normalize_guarded(jnp.cross(e1, e2)), 0.0
        ),
        mat_ri=(
            jnp.where(hit, world.mat_ri[idx], 1.5)
            if world.mat_ri is not None
            else None
        ),
    )


def trace_pallas_diff(
    world: WorldTriangles, ro: jax.Array, rd: jax.Array, alive=None
) -> HitRecord:
    """Drop-in differentiable tracer with the Pallas kernel's forward speed.

    Same result contract as ``trace_pallas`` / ``trace_mxu``; gradients of
    (t, normal, mat_color) w.r.t. scene parameters flow through
    :func:`hit_from_index`.
    """
    from ..pallas.trace import trace_pallas

    rd_n = normalize(rd)
    rec, idx = trace_pallas(
        jax.lax.stop_gradient(world),
        jax.lax.stop_gradient(ro),
        jax.lax.stop_gradient(rd_n),
        alive=alive,
        return_idx=True,
    )
    hit = rec.t < F_MAX  # already gradient-free: all kernel inputs stopped
    return hit_from_index(world, ro, rd_n, idx, hit)
