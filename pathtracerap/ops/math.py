"""Vector/transform math shared by traversal and shading.

Mirrors the reference's device helpers (``utility.h:64-88``), including the
reference's *non-standard* reflection formula, kept behind
:func:`reflect_parity` (``utility.h:64-69`` computes ``n - 2 (i . n) n``
instead of the standard ``i - 2 (i . n) n`` — a behavioral quirk that shapes
its REFLECTIVE and COAT renders and must be reproduced for parity).
All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# A float32 product without a stated precision may run in TF32 on the GPU
# (~1e-3 relative error: about 1 world unit at the reference scene's scale,
# ten times the 0.1 spawn offset).  Every f32 product here asks for full
# precision.
HIGHEST = jax.lax.Precision.HIGHEST


def normalize(v: jnp.ndarray, axis: int = -1, eps: float = 0.0) -> jnp.ndarray:
    n = jnp.linalg.norm(v, axis=axis, keepdims=True)
    if eps:
        n = jnp.maximum(n, eps)
    return v / n


def normalize_guarded(
    v: jnp.ndarray, axis: int = -1, eps: float = 1e-30
) -> jnp.ndarray:
    """AD-safe normalize for possibly-zero vectors (r5).

    ``normalize(v, eps=...)`` returns a finite VALUE at v == 0, but its
    reverse-mode gradient is NaN there (``linalg.norm``'s VJP is v/|v|):
    a single degenerate triangle — e.g. a sphere-cap sliver whose
    geometric normal is the zero cross product — poisoned every
    quality-mode pixel gradient through the cosine factor.  Zero rows
    return the +x axis and contribute exactly zero gradient
    (the double-``where`` rule)."""
    sq = jnp.sum(v * v, axis=axis, keepdims=True)
    ok = sq > eps
    fallback = jnp.zeros_like(v).at[..., 0].set(1.0)
    v_safe = jnp.where(ok, v, fallback)
    return v_safe / jnp.linalg.norm(v_safe, axis=axis, keepdims=True)


def transform_position(p: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """``vec3(M @ vec4(p, 1))`` (utility.h:77-80). p: (..., 3), m: (4, 4)."""
    return jnp.matmul(p, m[:3, :3].T, precision=HIGHEST) + m[:3, 3]


def transform_direction(d: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """``vec3(M @ vec4(d, 0))`` (utility.h:71-74)."""
    return jnp.matmul(d, m[:3, :3].T, precision=HIGHEST)


def inv3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form cofactor inverse of (..., 3, 3) matrices.

    Used instead of ``jnp.linalg.inv`` everywhere on the compute path: the
    LU-based inverse lowers to solver loops (a library call on the GPU)
    that block fusion into the render program and its gradient.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = -(d * i - f * g)
    cc = d * h - e * g
    cd = -(b * i - c * h)
    ce = a * i - c * g
    cf = -(a * h - b * g)
    cg = b * f - c * e
    ch = -(a * f - c * d)
    ci = a * e - b * d
    det = a * ca + b * cb + c * cc
    # inverse = cofactor^T / det
    inv = jnp.stack(
        [
            jnp.stack([ca, cd, cg], axis=-1),
            jnp.stack([cb, ce, ch], axis=-1),
            jnp.stack([cc, cf, ci], axis=-1),
        ],
        axis=-2,
    )
    return inv / det[..., None, None]


def transform_normal(n: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Inverse-transpose of the upper-left 3x3 (utility.h:82-88)."""
    it = inv3x3(m[:3, :3]).T
    return jnp.matmul(n, it.T, precision=HIGHEST)


def reflect_parity(incident: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """The reference's quirky ``reflectRay``: ``n - 2 (i . n) n``
    (utility.h:64-69)."""
    d = jnp.sum(incident * normal, axis=-1, keepdims=True)
    return normal - 2.0 * d * normal


def reflect_standard(incident: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """Physically standard mirror reflection ``i - 2 (i . n) n``."""
    d = jnp.sum(incident * normal, axis=-1, keepdims=True)
    return incident - 2.0 * d * normal


def dot3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1)


def cross3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)
