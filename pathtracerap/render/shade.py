"""Branchless wavefront shading.

``shadeRayKernel``'s material branch (``Renderer.cpp:411-479``) becomes a
masked select over the whole wavefront: every lane computes every scatter
candidate (cheap, VPU-elementwise) and ``jnp.where`` picks by material id.
The reference's thread divergence disappears by construction; its stream
compaction (``Renderer.cpp:497-519,625-634``) becomes the ``alive`` mask —
dead lanes simply stop changing state, which is exactly what compacting them
out achieved (SURVEY.md section 7 design stance).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .. import constants
from ..ops.intersect import HitRecord
from ..ops.math import normalize, reflect_parity, reflect_standard
from ..ops.sampling import (
    coat_scatter,
    cosine_hemisphere,
    metal_scatter,
    refract_scatter,
)
from ..scene.types import MaterialType
from ..utils.pytree import pytree_dataclass

F_MAX = constants.FLOAT_MAX


@pytree_dataclass
class RayState:
    """Wavefront ray state — SoA analog of ``Ray`` (``Primitive.h:158-178``)."""

    orig: jax.Array  # (N, 3)
    dir: jax.Array  # (N, 3)
    color: jax.Array  # (N, 3) path throughput
    remaining: jax.Array  # (N,) i32 remaining bounces

    @classmethod
    def primary(cls, ro, rd, max_bounces: int) -> "RayState":
        n = ro.shape[0]
        return cls(
            orig=ro,
            dir=rd,
            color=jnp.ones((n, 3), jnp.float32),
            remaining=jnp.full((n,), max_bounces, jnp.int32),
        )


def shade(state: RayState, hits: HitRecord, uniforms: jax.Array, parity: bool = True) -> RayState:
    """One wavefront shading step.

    uniforms: (N, 4) pre-drawn for this (sample, depth).  Lanes with
    ``remaining <= 0`` are dead (the reference compacts them away,
    ``Renderer.cpp:628``) and are left untouched.
    """
    alive = state.remaining > 0
    hit = hits.t < F_MAX
    # Every scatter candidate is computed for every lane before masking;
    # miss lanes carry ZERO normals, and normalize(cross(0, seed)) inside
    # the samplers is NaN in forward AND reverse mode (a zero cotangent
    # does not stop a NaN from propagating through jnp.where's VJP) —
    # substitute a harmless unit normal on non-hit lanes.  Values are
    # unchanged: every state update is masked by ``shaded = alive & hit``.
    unit_z = jnp.zeros_like(hits.normal).at[..., 2].set(1.0)
    n = jnp.where(hit[:, None], hits.normal, unit_z)
    u = uniforms

    d = normalize(state.dir)
    pt = state.orig + d * hits.t[:, None]
    spawn = pt + constants.SPAWN_OFFSET * n

    mt = hits.mat_type
    is_diffuse = mt == int(MaterialType.DIFFUSE)
    is_metal = mt == int(MaterialType.METAL)
    is_coat = mt == int(MaterialType.COAT)
    is_emissive = mt == int(MaterialType.EMISSIVE)
    is_reflective = mt == int(MaterialType.REFLECTIVE)

    reflect = reflect_parity if parity else reflect_standard

    dir_diffuse = cosine_hemisphere(n, u[:, 0], u[:, 1])
    dir_metal = metal_scatter(n, d, u[:, 2], u[:, 3])
    dir_coat = coat_scatter(n, d, u[:, 0], u[:, 1], u[:, 2], parity=parity)
    dir_refl = reflect(d, n)

    scatters = is_diffuse | is_metal | is_coat | is_reflective
    new_dir = jnp.where(
        is_diffuse[:, None],
        dir_diffuse,
        jnp.where(
            is_metal[:, None],
            dir_metal,
            jnp.where(is_coat[:, None], dir_coat, dir_refl),
        ),
    )

    if not parity:
        # quality mode shades the two materials the reference declares but
        # never branches on (Primitive.h:70-84 vs Renderer.cpp:433-467):
        # SPECULAR = perfect mirror, REFRACTIVE = Fresnel-roulette
        # dielectric using the data model's refractive_index
        is_specular = mt == int(MaterialType.SPECULAR)
        is_refractive = mt == int(MaterialType.REFRACTIVE)
        ri = (
            hits.mat_ri[:, None]
            if hits.mat_ri is not None
            else jnp.full_like(hits.t[:, None], 1.5)
        )
        dir_refr, orient = refract_scatter(n, d, ri, u[:, 3])
        scatters = scatters | is_specular | is_refractive
        new_dir = jnp.where(
            is_refractive[:, None],
            dir_refr,
            jnp.where(is_specular[:, None], dir_refl, new_dir),
        )
        # transmitted rays must spawn BELOW the surface
        spawn = jnp.where(
            is_refractive[:, None],
            pt + constants.SPAWN_OFFSET * orient * n,
            spawn,
        )
    # In parity mode SPECULAR / REFRACTIVE have no shading branch, exactly
    # like the reference: the ray keeps its direction and origin and just
    # burns a bounce.
    shaded = alive & hit
    upd_dir = shaded & scatters
    upd_col = shaded & (scatters | is_emissive)

    new_orig = jnp.where(upd_dir[:, None], spawn, state.orig)
    new_direction = jnp.where(upd_dir[:, None], new_dir, state.dir)
    mat_c = hits.mat_color
    if not parity:
        # quality mode restores the cosine throughput factor the reference
        # commented out (Renderer.cpp:438: `* dot(normalize(dir), normal)`)
        # — against the GEOMETRIC normal, so pixel color carries real
        # vertex-position gradients (see HitRecord.geom_normal; against the
        # shading normal the factor is identically sqrt(u0)).
        gn = hits.geom_normal if hits.geom_normal is not None else n
        gn = jnp.where(hit[:, None], gn, unit_z)  # same miss-lane guard
        cosf = jnp.sum(dir_diffuse * gn, axis=-1, keepdims=True)
        mat_c = mat_c * jnp.where(is_diffuse[:, None], jnp.maximum(cosf, 0.0), 1.0)
    color = jnp.where(upd_col[:, None], state.color * mat_c, state.color)

    # miss: 0.01 ambient attenuation + kill (Renderer.cpp:471-477)
    missed = alive & ~hit
    color = jnp.where(missed[:, None], color * constants.MISS_ATTENUATION, color)

    # remaining: emissive kills without decrement (Renderer.cpp:454-460),
    # miss kills (Renderer.cpp:473), others decrement (Renderer.cpp:478)
    kill = missed | (shaded & is_emissive)
    remaining = jnp.where(
        kill,
        0,
        jnp.where(alive, state.remaining - 1, state.remaining),
    )

    return RayState(orig=new_orig, dir=new_direction, color=color, remaining=remaining)


def gather_contribution(state: RayState) -> jax.Array:
    """Per-iteration gamma-2 tone map: sqrt of final throughput
    (``gatherImageDataKernel``, ``Renderer.cpp:481-496``)."""
    return jnp.sqrt(jnp.maximum(state.color, 0.0))
