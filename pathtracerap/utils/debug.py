"""Checkify'd debug mode for the Pallas traversal kernel (SURVEY.md §5).

The kernel (``pallas/trace.py``) is compiled by Triton for the GPU, while
the CPU tests run it in the Pallas interpreter, whose arithmetic is XLA's.
A lowering change (fast-math division, a contracted FMA order, a changed
reduction) could make the compiled kernel accept or reject what the
interpreter does not, and no CPU test would notice.

:func:`checked_trace` is the guard: it runs the kernel under
``jax.experimental.checkify`` and asserts the output invariants — hit
distances are finite-or-sentinel and ``>= -EPSILON``, indices are in range,
no padding triangle is accepted, and the kernel agrees with the plain XLA
sweep (``ops/plucker.trace_mxu``).  With ``PTAP_DEBUG=1`` the
:class:`~pathtracerap.render.wavefront.Renderer` facade runs it on a
slice of primary rays before every render on the ``pallas`` engine.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
from jax.experimental import checkify

from .. import constants

F_MAX = constants.FLOAT_MAX
EPS = constants.EPSILON


def debug_enabled() -> bool:
    """True when PTAP_DEBUG=1: renders validate the kernel first."""
    return os.environ.get("PTAP_DEBUG", "0") == "1"


def _trace_invariants(world, ro, rd):
    """Checkified invariants of one kernel traversal (see module doc)."""
    from ..ops.math import normalize
    from ..ops.plucker import trace_mxu
    from ..pallas.trace import trace_pallas

    rec, idx = trace_pallas(world, ro, normalize(rd), return_idx=True)
    hit = rec.t < F_MAX

    checkify.check(
        jnp.all(jnp.isfinite(jnp.where(hit, rec.t, 0.0))),
        "kernel returned non-finite hit distance",
    )
    checkify.check(
        jnp.all(jnp.where(hit, rec.t, 0.0) >= -EPS),
        "kernel accepted a hit below the -EPSILON floor (Renderer.cpp:201)",
    )
    n_tris = world.valid.shape[0]
    checkify.check(
        jnp.all((idx >= 0) & (idx < n_tris)),
        "kernel hit index out of range",
    )
    checkify.check(
        jnp.all(jnp.where(hit, world.valid[idx], 1.0) > 0.0),
        "kernel accepted a padding (invalid) triangle",
    )
    # cross-engine agreement with the plain XLA sweep: per-ray distances
    # must match to fp tolerance
    ref = trace_mxu(world, ro, rd)
    scale = jnp.maximum(jnp.max(jnp.where(hit, rec.t, 0.0)), 1.0)
    both_hit = hit & (ref.t < F_MAX)
    checkify.check(
        jnp.all(jnp.where(both_hit, jnp.abs(rec.t - ref.t), 0.0) <= 1e-4 * scale),
        "kernel hit distances diverge from the XLA sweep",
    )
    checkify.check(
        jnp.all(hit == (ref.t < F_MAX)),
        "kernel hit/miss classification diverges from the XLA sweep",
    )
    return rec


def checked_trace(world, ro, rd):
    """Run one traversal with the invariants above; raises on violation.

    Returns the HitRecord.  Intended for debug-mode spot checks (the
    Renderer facade validates a slice of primary rays per render when
    ``PTAP_DEBUG=1``).
    """
    err, rec = checkify.checkify(_trace_invariants)(world, ro, rd)
    err.throw()
    return rec
