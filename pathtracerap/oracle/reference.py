"""Scalar NumPy oracle of the reference renderer's semantics.

A direct, deliberately *slow* per-ray transliteration of the reference's
device code (``Renderer.cpp:150-496``, ``utility.h:64-170``), used only by
tests as the ground truth the vectorized/jitted engines must match
(SURVEY.md section 4: the reference itself ships no tests; its author's own
oracle was a scalar CPU prototype kept in ``backup.txt``).

Everything runs in float32 to match the device engines' arithmetic, but
:func:`hits_f64` and :func:`tied_hits`, which judge two f32 engines'
nearest hits against float64.
"""

from __future__ import annotations

import numpy as np

from .. import constants
from ..scene.types import SceneHost

F_MAX = np.float32(constants.FLOAT_MAX)
F_MIN = np.float32(constants.FLOAT_MIN)
EPS = np.float32(constants.EPSILON)
f32 = np.float32


def _norm(v):
    return v / np.sqrt(np.dot(v, v), dtype=np.float32)


def _xform_pos(p, m):
    return (m[:3, :3] @ p + m[:3, 3]).astype(np.float32)


def _xform_dir(d, m):
    return (m[:3, :3] @ d).astype(np.float32)


def _xform_normal(n, m):
    it = np.linalg.inv(m[:3, :3].astype(np.float64)).T.astype(np.float32)
    return (it @ n).astype(np.float32)


def slab_scalar(ro, rd, inv_dir, bb_min, bb_max):
    """``computeRayBoundingBoxIntersection`` (Renderer.cpp:150-170)."""
    t = np.empty(6, np.float32)
    for a in range(3):
        if rd[a] == 0.0:
            t[2 * a], t[2 * a + 1] = F_MIN, F_MAX
        else:
            t[2 * a] = (bb_min[a] - ro[a]) * inv_dir[a]
            t[2 * a + 1] = (bb_max[a] - ro[a]) * inv_dir[a]
    tmin = max(min(t[0], t[1]), min(t[2], t[3]), min(t[4], t[5]))
    tmax = min(max(t[0], t[1]), max(t[2], t[3]), max(t[4], t[5]))
    if tmax < 0 or tmin > tmax:
        return False, np.float32(0.0)
    return True, np.float32(tmin)


def mt_scalar(ro, rd, v0, v1, v2):
    """``computeRayTriangleIntersection`` core (Renderer.cpp:174-215).

    Returns (accept, t).
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = np.cross(rd, e2).astype(np.float32)
    det = np.dot(e1, pvec).astype(np.float32)
    if abs(det) < EPS:
        return False, np.float32(0.0)
    inv_det = np.float32(1.0) / det
    tvec = (ro - v0).astype(np.float32)
    u = np.dot(tvec, pvec) * inv_det
    if u < -EPS or u > 1.0 + EPS:
        return False, np.float32(0.0)
    qvec = np.cross(tvec, e1).astype(np.float32)
    v = np.dot(rd, qvec) * inv_det
    if v < -EPS or u + v > 1.0 + EPS:
        return False, np.float32(0.0)
    t = np.dot(e2, qvec) * inv_det
    if t < -EPS:
        return False, np.float32(0.0)
    return True, np.float32(t)


def hits_f64(ro, rd, v0, e1, e2, eps=float(EPS)):
    """Float64 Moeller-Trumbore of ray ``i`` against triangle ``i`` (all
    (n, 3)), with the accept chain of the traversal engines (det != 0,
    barycentric slack ``eps``): ``(t, accepted)``."""
    ro, rd, v0, e1, e2 = (np.asarray(x, np.float64) for x in (ro, rd, v0, e1, e2))
    dot = lambda a, b: np.einsum("ij,ij->i", a, b)
    p = np.cross(rd, e2)
    det = dot(e1, p)
    inv = 1.0 / np.where(det == 0.0, 1.0, det)
    s = ro - v0
    q = np.cross(s, e1)
    u, v, t = dot(s, p) * inv, dot(rd, q) * inv, dot(e2, q) * inv
    ok = ((det != 0.0) & (u >= -eps) & (u <= 1.0 + eps) & (v >= -eps)
          & (u + v <= 1.0 + eps) & (t >= -eps))
    return t, ok


def tied_hits(world, ro, rd, i_a, i_b, rtol=1e-5):
    """For rays where two f32 engines report triangles ``i_a`` and ``i_b``
    of a baked ``world``: ``(tie, shared)``, both (n,) bool.

    ``tie``: the two picks are equally right — their float64 plane
    distances agree within ``rtol``, and float64 accepts both, or the two
    share a vertex and float64 puts the ray within twice the EPSILON slack
    of both (f32 rounding of a barycentric coordinate at the slack's
    edge).  That is a ray on a shared edge, or where coplanar neighbours'
    slack overlaps, whose winner only f32 rounding decides.  ``shared``:
    the two triangles share a vertex."""
    geo = lambda i: tuple(np.asarray(getattr(world, k), np.float64)[i]
                          for k in ("v0", "e1", "e2"))
    a, b = geo(i_a), geo(i_b)
    t_a, ok_a = hits_f64(ro, rd, *a)
    t_b, ok_b = hits_f64(ro, rd, *b)
    near = hits_f64(ro, rd, *a, eps=2 * float(EPS))[1] & hits_f64(
        ro, rd, *b, eps=2 * float(EPS))[1]
    same_t = np.abs(t_a - t_b) <= rtol * np.maximum(np.abs(t_a), np.abs(t_b))
    corners = lambda g: np.stack([g[0], g[0] + g[1], g[0] + g[2]], axis=1)
    ca, cb = corners(a), corners(b)  # (n, 3, 3)
    gap = np.linalg.norm(ca[:, :, None] - cb[:, None], axis=-1).min(axis=(1, 2))
    # v0 + e1 rounds differently for two triangles of one vertex
    shared = gap <= 1e-6 * np.maximum(np.abs(ca).max(axis=(1, 2)), 1.0)
    return same_t & ((ok_a & ok_b) | (shared & near)), shared


def _tri_normal(scene: SceneHost, itri):
    vi = scene.tri_vidx[itri]
    n = (
        scene.vertex_nrm[vi[0]] + scene.vertex_nrm[vi[1]] + scene.vertex_nrm[vi[2]]
    ) * np.float32(1.0 / 3.0)
    return _norm(n.astype(np.float32))


def grid_traverse_scalar(scene: SceneHost, imodel: int, ro_w, rd_w):
    """``computeRayGridIntersection`` for one ray and one model
    (Renderer.cpp:238-360 with the kernel's surrounding transforms,
    Renderer.cpp:377-391).

    Returns (is_intersect, t_model, normal_model, ro_m, rd_m).
    """
    gx, gy, gz = scene.grid_dims
    w2m = scene.world_to_model[imodel]
    mesh = scene.model_mesh[imodel]
    grid = scene.model_grid[imodel]
    bb_min = scene.mesh_bbox_min[mesh]
    bb_max = scene.mesh_bbox_max[mesh]
    vw = scene.grid_voxel_width[grid]
    base = int(scene.grid_voxel_start[grid])

    ro = _xform_pos(np.asarray(ro_w, np.float32), w2m)
    rd = _norm(_xform_dir(np.asarray(rd_w, np.float32), w2m))
    with np.errstate(divide="ignore"):
        inv_dir = (np.float32(1.0) / rd).astype(np.float32)

    no_hit = (False, F_MAX, np.zeros(3, np.float32), ro, rd)

    ok, t_box = slab_scalar(ro, rd, inv_dir, bb_min, bb_max)
    if not ok:
        return no_hit
    entry = (ro + rd * t_box).astype(np.float32)
    if np.any((entry - bb_min) < -EPS):
        return no_hit

    ivox = np.abs(entry - bb_min + EPS) / vw
    ivox = np.clip(ivox.astype(np.int64), 0, np.array([gx, gy, gz]) - 1)

    dims = np.array([gx, gy, gz])
    step = np.where(rd > 0, 1, -1)
    out = np.where(rd > 0, dims, -1)
    tmax = np.full(3, F_MAX, np.float32)
    delta = np.full(3, F_MAX, np.float32)
    for a in range(3):
        if rd[a] != 0:
            i_next = ivox[a] + 1 if rd[a] > 0 else ivox[a]
            pos_next = np.float32(bb_min[a] + i_next * vw[a])
            delta[a] = abs(np.float32(vw[a] * inv_dir[a]))
            tmax[a] = np.float32((pos_next - entry[a]) * inv_dir[a])

    best_t = F_MAX
    best_n = np.zeros(3, np.float32)
    is_int = False
    cache = ivox.copy()

    while True:
        flat = base + int(ivox[0] + ivox[1] * gx + ivox[2] * gx * gy)
        s = int(scene.voxel_tri_start[flat])
        c = int(scene.voxel_tri_count[flat])
        voxel_hit = False
        for k in range(c):
            itri = int(scene.per_voxel_tris[s + k])
            vi = scene.tri_vidx[itri]
            acc, t = mt_scalar(
                ro, rd, scene.vertex_pos[vi[0]], scene.vertex_pos[vi[1]], scene.vertex_pos[vi[2]]
            )
            if acc:
                voxel_hit = True
                if best_t > t:
                    best_t = t
                    best_n = _tri_normal(scene, itri)
        if voxel_hit:
            cache = ivox.copy()
            is_int = True
        if is_int and np.any(np.abs(cache - ivox) > 2):
            return True, best_t, best_n, ro, rd

        if tmax[0] < tmax[1] and tmax[0] < tmax[2]:
            a = 0
        elif tmax[1] < tmax[2]:
            a = 1
        else:
            a = 2
        ivox[a] += step[a]
        if ivox[a] == out[a] or tmax[a] >= F_MAX:
            return is_int, best_t, best_n, ro, rd
        tmax[a] = np.float32(tmax[a] + delta[a])


def trace_scalar(scene: SceneHost, ro_w, rd_w):
    """``computeRaySceneIntersectionKernel`` for one ray
    (Renderer.cpp:363-409).  Returns dict(t, normal, mat_type, mat_color)."""
    ro_w = np.asarray(ro_w, np.float32)
    rd_w = np.asarray(rd_w, np.float32)
    g_t = F_MAX
    g_n = np.zeros(3, np.float32)
    g_mt = 0
    g_mc = np.zeros(3, np.float32)
    for imodel in range(scene.num_models):
        is_int, t_m, n_m, ro_m, rd_m = grid_traverse_scalar(scene, imodel, ro_w, rd_w)
        if not is_int:
            continue
        m2w = scene.model_to_world[imodel]
        model_pt = (ro_m + rd_m * t_m).astype(np.float32)
        world_pt = _xform_pos(model_pt, m2w)
        wd = np.float32(np.sqrt(np.dot(world_pt - ro_w, world_pt - ro_w)))
        if g_t > wd:
            g_t = wd
            g_n = _norm(_xform_normal(n_m, m2w))
            g_mt = int(scene.mat_type[imodel])
            g_mc = scene.mat_color[imodel]
    return dict(t=g_t, normal=g_n, mat_type=g_mt, mat_color=g_mc)


# ----------------------------------------------------------------- shading
def _reflect_parity(i, n):
    return (n - 2.0 * np.dot(i, n) * n).astype(np.float32)


def _cosine_hemisphere(n, u0, u1):
    up = np.sqrt(u0, dtype=np.float32)
    over = np.sqrt(max(np.float32(1.0) - up * up, np.float32(0.0)), dtype=np.float32)
    around = np.float32(u1 * constants.TWO_PI)
    if abs(n[0]) < constants.SQRT_OF_ONE_THIRD:
        seed = np.array([1, 0, 0], np.float32)
    elif abs(n[1]) < constants.SQRT_OF_ONE_THIRD:
        seed = np.array([0, 1, 0], np.float32)
    else:
        seed = np.array([0, 0, 1], np.float32)
    t1 = _norm(np.cross(n, seed).astype(np.float32))
    t2 = _norm(np.cross(n, t1).astype(np.float32))
    return (up * n + np.cos(around) * over * t1 + np.sin(around) * over * t2).astype(np.float32)


def _metal_scatter(n, d, u2, u3):
    phi = np.float32(constants.TWO_PI * u2)
    cos_t = np.float32((1.0 - u3) ** (1.0 / (constants.METAL_PHONG_EXPONENT + 1.0)))
    sin_t = np.sqrt(max(np.float32(1.0) - cos_t * cos_t, np.float32(0.0)), dtype=np.float32)
    w = _norm((d - n * 2.0 * np.dot(n, d)).astype(np.float32))
    seed = np.array([0, 1, 0], np.float32) if abs(w[0]) > 0.1 else np.array([1, 0, 0], np.float32)
    u = _norm(np.cross(seed, w).astype(np.float32))
    v = np.cross(w, u).astype(np.float32)
    return (u * np.cos(phi) * sin_t + v * np.sin(phi) * sin_t + w * cos_t).astype(np.float32)


def _coat_scatter(n, d, u0, u1, u2):
    if u0 < constants.COAT_REFLECT_PROBABILITY:
        return _reflect_parity(d, n)
    return _cosine_hemisphere(n, u1, u2)


def shade_scalar(ray, hit, uniforms):
    """``shadeRayKernel`` for one ray (Renderer.cpp:411-479).

    ray: dict(orig, dir, color, remaining); hit: dict from trace_scalar plus
    ``t``; uniforms: 4 floats for this (iter, ray, depth).  Mutates and
    returns ray.  ``hit['t'] >= FLOAT_MAX`` means miss.
    """
    M = constants
    if ray["remaining"] <= 0:
        ray["color"] = ray["color"] * np.float32(M.MISS_ATTENUATION)
    if hit["t"] < F_MAX:
        d = _norm(ray["dir"].astype(np.float32))
        pt = (ray["orig"] + d * hit["t"]).astype(np.float32)
        if ray["remaining"] > 0:
            mt = hit["mat_type"]
            n = hit["normal"]
            u = uniforms
            if mt == 0:  # DIFFUSE
                ray["dir"] = _cosine_hemisphere(n, u[0], u[1])
                ray["orig"] = pt + np.float32(M.SPAWN_OFFSET) * n
                ray["color"] = ray["color"] * hit["mat_color"]
            elif mt == 6:  # METAL
                ray["dir"] = _metal_scatter(n, d, u[2], u[3])
                ray["orig"] = pt + np.float32(M.SPAWN_OFFSET) * n
                ray["color"] = ray["color"] * hit["mat_color"]
            elif mt == 5:  # COAT
                ray["dir"] = _coat_scatter(n, d, u[0], u[1], u[2])
                ray["orig"] = pt + np.float32(M.SPAWN_OFFSET) * n
                ray["color"] = ray["color"] * hit["mat_color"]
            elif mt == 4:  # EMISSIVE: kill, no decrement (Renderer.cpp:454-460)
                ray["remaining"] = 0
                ray["color"] = ray["color"] * hit["mat_color"]
                return ray
            elif mt == 2:  # REFLECTIVE (quirky reflect, Renderer.cpp:461-467)
                ray["color"] = ray["color"] * hit["mat_color"]
                refl = _reflect_parity(d, hit["normal"])
                ray["orig"] = pt + np.float32(M.SPAWN_OFFSET) * hit["normal"]
                ray["dir"] = refl
            # SPECULAR/REFRACTIVE: no branch in the reference -> unchanged ray
    else:  # miss (Renderer.cpp:471-477)
        ray["remaining"] = 0
        ray["color"] = ray["color"] * np.float32(M.MISS_ATTENUATION)
        return ray
    ray["remaining"] -= 1
    return ray


def render_scalar(scene: SceneHost, rays_o, rays_d, uniforms, max_bounces=5):
    """Path-trace one sample iteration for a small wavefront.

    uniforms: (max_bounces, N, 4) pre-drawn; returns per-ray gathered
    contribution sqrt(color) (Renderer.cpp:481-496).
    """
    n = rays_o.shape[0]
    out = np.zeros((n, 3), np.float32)
    for i in range(n):
        ray = dict(
            orig=np.asarray(rays_o[i], np.float32),
            dir=np.asarray(rays_d[i], np.float32),
            color=np.ones(3, np.float32),
            remaining=max_bounces,
        )
        for b in range(max_bounces):
            if ray["remaining"] <= 0:
                break
            hit = trace_scalar(scene, ray["orig"], ray["dir"])
            shade_scalar(ray, hit, uniforms[b, i])
        out[i] = np.sqrt(ray["color"])
    return out
