"""Pluecker traversal: ray/triangle tests as K=6 dot products.

The reference's traversal (``Renderer.cpp:363-409``) is redesigned around
two observations:

1. The reference shades with a *flat* per-triangle normal (average of the
   three vertex normals, ``Renderer.cpp:203``), so no barycentric
   coordinates are needed downstream — a hit is fully described by
   (distance, triangle id).
2. The Moeller-Trumbore edge tests are, in Pluecker coordinates, *bilinear*
   in (ray, triangle): with per-ray ``W = [dir, orig x dir]`` (6 floats) and
   per-edge ``[p x q; q - p]`` (6 floats), the signed side value is a plain
   dot product.  Testing a wavefront of N rays against T triangles is then
   three ``(N, 6) @ (6, T)`` products followed by elementwise sign logic
   and an argmin.

The three side values satisfy ``s_ab + s_bc + s_ca = dir . n`` (n the
geometric normal), so the M-T determinant and barycentrics fall out for
free:  ``det = sum(s)``, ``u = s_ca / det``, ``v = s_ab / det``, and
``t = (d_plane - orig . n) / det``.  The reference's epsilon tests on
(u, v, u+v, t) are applied verbatim (they are unitless or world-unit
quantities).

All model instances are baked into one world-space soup (per-mesh grids and
per-model ray transforms disappear; the reference's 11-model loop becomes a
single sweep).  ``trace_mxu`` is the plain XLA form of the sweep and the
reference every other engine is checked against; ``pallas/trace.py`` is the
fused GPU kernel over the same soup.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from .. import constants
from ..scene.types import SceneDevice, WorldTriangles
from .intersect import HitRecord
from .math import inv3x3, normalize, normalize_guarded

F_MAX = constants.FLOAT_MAX
EPS = constants.EPSILON


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _morton3(p: jax.Array, lo: jax.Array, hi: jax.Array) -> jax.Array:
    """30-bit Morton code of points ``p`` (T, 3) within AABB [lo, hi]."""
    q = jnp.clip(
        (p - lo) / jnp.maximum(hi - lo, 1e-30) * 1023.0, 0.0, 1023.0
    ).astype(jnp.int32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def bake_world_triangles(
    scene: SceneDevice, tri_block: int = 512, ring_shards: int | None = None,
    sort: bool = True,
) -> WorldTriangles:
    """Bake all model instances into a world-space triangle soup.

    Pure jnp so gradients flow back to ``scene.vertex_pos`` /
    ``scene.model_to_world`` / material colors (inverse rendering).

    Triangles are sorted by the Morton code of their world centroid, so
    contiguous runs are spatially coherent — the culling granularity of the
    traversal kernel (block AABBs) tightens from "whichever
    triangles the models happened to emit adjacently" to real spatial
    locality.  Hit results are order-independent (nearest-t reduction;
    exact-t ties resolve to the lowest triangle index in every engine).

    ``tri_block`` is the culling block width: the soup is padded to a
    multiple of it and ``block_aabb`` holds one box per block, for the
    traversal kernel's per-tile worklists (``pallas/trace.py``).

    ``ring_shards=D`` bakes for the geometry-sharded ring (parallel/
    geometry.py): the triangle axis is padded to ``D * tri_block`` so the
    kernel pack splits into D equal contiguous block groups, and
    ``block_aabb`` keeps its padding blocks as NaN rows (every slab/frustum
    comparison with NaN is false, so worklist builders can never select
    them) instead of truncating — truncation would break the equal-shard
    layout.

    ``sort=False`` keeps instance order (real and padding rows
    interleaved): two backends bake the same rows in the same places even
    where their f32 rounding would order near-equal Morton codes
    differently, which is what a cross-backend comparison of the bake
    needs.  Traversal needs the default.
    """
    src = scene.world_tri_src
    mdl = scene.world_tri_model
    # model-alignment padding entries carry src == -1: their vertices are
    # zeroed (degenerate triangle, det always 0 => never accepted)
    src_valid = (src >= 0).astype(jnp.float32)[:, None]
    vidx = scene.tri_vidx[jnp.maximum(src, 0)]  # (Tw, 3)

    m2w = scene.model_to_world[mdl]  # (Tw, 4, 4)
    rot = m2w[:, :3, :3]
    trans = m2w[:, :3, 3]

    def xform(p):  # (Tw, 3) model-space points
        return (
            jnp.einsum("tij,tj->ti", rot, p, precision=jax.lax.Precision.HIGHEST)
            + trans
        ) * src_valid

    a = xform(scene.vertex_pos[vidx[:, 0]])
    b = xform(scene.vertex_pos[vidx[:, 1]])
    c = xform(scene.vertex_pos[vidx[:, 2]])

    # Pluecker edge columns [p x q ; q - p] for edges (a,b), (b,c), (c,a)
    def edge(p, q):
        return jnp.concatenate([jnp.cross(p, q), q - p], axis=-1)  # (Tw, 6)

    e_ab = edge(a, b)
    e_bc = edge(b, c)
    e_ca = edge(c, a)

    n = jnp.cross(b - a, c - a)
    d_plane = jnp.sum(n * a, axis=-1)

    # shading normal: inverse-transpose of the per-model 3x3 applied to the
    # averaged vertex normal (Renderer.cpp:203,397 + utility.h:82-88)
    inv_t = jnp.transpose(inv3x3(scene.model_to_world[:, :3, :3]), (0, 2, 1))
    navg = (
        scene.vertex_nrm[vidx[:, 0]]
        + scene.vertex_nrm[vidx[:, 1]]
        + scene.vertex_nrm[vidx[:, 2]]
    ) * (1.0 / 3.0)
    navg = jnp.where(src_valid > 0, navg, jnp.array([1.0, 0.0, 0.0]))
    shade_n = normalize_guarded(
        jnp.einsum("tij,tj->ti", inv_t[mdl], navg,
                   precision=jax.lax.Precision.HIGHEST)
    )

    mat_type = scene.mat_type[mdl]
    mat_color = scene.mat_color[mdl]
    mat_ri = (
        scene.mat_refractive_index[mdl]
        if scene.mat_refractive_index is not None
        else jnp.full(mdl.shape, 1.5, jnp.float32)
    )
    tri_model = mdl

    # Sort world triangles into (fat | small-by-Morton | padding) order:
    #
    # * "fat" triangles (extent above ~15% of the scene diagonal — the
    #   enclosing-box walls, Scene.cpp:57-70) would poison every Morton
    #   block's AABB they land in, making block culling useless (measured:
    #   7.2/8 blocks slab-reachable per primary tile with a global Morton
    #   sort).  They get their own leading block(s).
    # * fat-FIRST visit order seeds every ray's running best_t with a wall
    #   hit on the first visit, so the per-visit `tmin <= best_t + margin`
    #   test prunes the tight blocks behind it — the wavefront analog of
    #   the reference's DDA early-exit (Renderer.cpp:326-329), still
    #   conservative.
    # * ties stay consistent across engines because every engine breaks
    #   exact-t ties by lowest index IN THIS BAKED ORDER.
    centroid = (a + b + c) * (1.0 / 3.0)
    scene_lo = jnp.min(jnp.where(src_valid > 0, centroid, F_MAX), axis=0)
    scene_hi = jnp.max(jnp.where(src_valid > 0, centroid, -F_MAX), axis=0)
    code = _morton3(centroid, scene_lo, scene_hi)
    tmin_ = jnp.minimum(jnp.minimum(a, b), c)
    tmax_ = jnp.maximum(jnp.maximum(a, b), c)
    diag_t = jnp.linalg.norm(tmax_ - tmin_, axis=-1)
    diag_s = jnp.linalg.norm(jnp.maximum(scene_hi - scene_lo, 1e-30))
    fat = diag_t > 0.15 * diag_s
    klass = jnp.where(
        src_valid[:, 0] > 0, jnp.where(fat, 0, 1), 2
    ).astype(jnp.int32)
    perm = jnp.argsort(code, stable=True)
    perm = perm[jnp.argsort(klass[perm], stable=True)]
    if not sort:
        perm = jnp.arange(perm.shape[0])
    (a, b, c, e_ab, e_bc, e_ca, n, d_plane, shade_n, mat_type, mat_color,
     mat_ri, src_valid, tri_model) = (
        x[perm]
        for x in (a, b, c, e_ab, e_bc, e_ca, n, d_plane, shade_n, mat_type,
                  mat_color, mat_ri, src_valid, tri_model)
    )

    tw = a.shape[0]
    # static real-triangle count (model-padding rows sort last): the soup's
    # leading n_world_valid rows are the hittable triangles
    n_world_valid = int(scene.n_world_valid) or tw
    t_pad = _round_up(tw, tri_block * (ring_shards or 1))
    pad = t_pad - tw

    def padt(x, value=0.0):
        cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, cfg, constant_values=value)

    # edge-major layout: (3 edges, 6, T) — three (N,6)@(6,T) products
    edge_pluecker = jnp.stack(
        [padt(e_ab).T, padt(e_bc).T, padt(e_ca).T], axis=0
    )  # (3, 6, T)
    tri_pack = jnp.concatenate(
        [edge_pluecker.reshape(18, t_pad), padt(n).T, padt(d_plane)[None, :]],
        axis=0,
    )  # (22, T)

    # per-block AABBs for the kernel's worklists; padding triangles
    # contribute an inverted AABB (min=+FMAX, max=-FMAX)
    tri_min = jnp.where(src_valid > 0, jnp.minimum(jnp.minimum(a, b), c), F_MAX)
    tri_max = jnp.where(src_valid > 0, jnp.maximum(jnp.maximum(a, b), c), -F_MAX)
    nb = t_pad // tri_block
    b_min = padt(tri_min, F_MAX).reshape(nb, tri_block, 3).min(axis=1)
    b_max = padt(tri_max, -F_MAX).reshape(nb, tri_block, 3).max(axis=1)
    # Inflate spatially: the EPSILON-slack barycentric accept (u, v down to
    # -EPS, Renderer.cpp:193-197) admits hit points up to ~2*EPS*edge_length
    # OUTSIDE the triangle — and at grazing angles no t-space margin can
    # cover a spatial miss, so the slack must be baked into the boxes.  The
    # absolute term is scale-relative (fp slab error grows with coordinate
    # magnitude), so millimeter- and kilometer-scale scenes get
    # proportionate slack instead of a fixed world-unit constant.
    scene_diag = jnp.linalg.norm(jnp.maximum(scene_hi - scene_lo, 0.0))
    b_diag = jnp.linalg.norm(jnp.maximum(b_max - b_min, 0.0), axis=-1, keepdims=True)
    b_pad = 2.0 * EPS * b_diag + 1e-5 * scene_diag + 1e-6
    block_aabb = jnp.concatenate(
        [b_min - b_pad, b_max + b_pad, jnp.zeros((nb, 2), jnp.float32)], axis=-1
    )  # (nb, 8)
    # Drop PURE-padding blocks structurally: their "inverted" AABB is not
    # unhittable under the min/max-swapped slab test (the swap turns
    # [+FMAX, -FMAX] into an always-hit ±inf box).  Real triangles come
    # first in the soup (fat | Morton | padding order), so the real blocks
    # are exactly the leading ceil(n_valid / tri_block).
    nb_real = -(-n_world_valid // tri_block)
    if ring_shards is None:
        block_aabb = block_aabb[:nb_real]
    else:
        # equal-shard layout: keep all nb rows, neutralize the pure-padding
        # ones with NaN (slab/frustum tests with NaN are false, so no
        # worklist ever selects them)
        row = jax.lax.broadcasted_iota(jnp.int32, block_aabb.shape, 0)
        block_aabb = jnp.where(row < nb_real, block_aabb, jnp.nan)

    return WorldTriangles(
        edge_pluecker=edge_pluecker,
        plane_n=padt(n),
        plane_d=padt(d_plane),
        shade_normal=padt(shade_n),
        mat_type=padt(mat_type).astype(jnp.int32),
        mat_color=padt(mat_color),
        mat_ri=padt(mat_ri, value=1.5),
        valid=jnp.pad(src_valid[:, 0], (0, pad)),
        v0=padt(a),
        e1=padt(b - a),
        e2=padt(c - a),
        tri_pack=tri_pack,
        block_aabb=block_aabb,
        tri_block=tri_block,
        n_valid=n_world_valid,
        tri_model=padt(tri_model).astype(jnp.int32),
        mat_table=scene.mat_color,
    )


def _trace_chunk(world: WorldTriangles, ro, rd_n):
    """Intersect one chunk of rays against the full soup.

    ro, rd_n: (n, 3) with rd_n normalized.  Returns (t (n,), tri_idx (n,)).
    """
    w = jnp.concatenate([rd_n, jnp.cross(ro, rd_n)], axis=-1)  # (n, 6)

    def side(e):
        # HIGHEST: a reduced-precision f32 product (TF32, bf16 passes) has
        # ~1e-3 relative error — at scene scale that swamps the 0.1 spawn
        # offset (Renderer.cpp:437), causing self-intersection acne
        return jax.lax.dot_general(
            w,
            world.edge_pluecker[e],
            dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # (n, T)

    s_ab, s_bc, s_ca = side(0), side(1), side(2)
    det = s_ab + s_bc + s_ca  # = dir . n
    # safe division: padding/parallel triangles have det == 0; dividing by
    # it poisons reverse-mode AD with NaN through the jnp.where (the
    # standard "double where" rule), so neutralize the denominator first.
    parallel = det == 0.0
    inv_det = 1.0 / jnp.where(parallel, 1.0, det)
    u = s_ca * inv_det  # weight of vertex b
    v = s_ab * inv_det  # weight of vertex c

    # t from the plane equation; dir . n == det (no extra matmul needed)
    o_dot_n = jax.lax.dot_general(
        ro,
        world.plane_n.T,
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # (n, T)
    t = (world.plane_d[None, :] - o_dot_n) * inv_det

    accept = (
        ~parallel
        & ~(u < -EPS)
        & ~(u > 1.0 + EPS)
        & ~(v < -EPS)
        & ~(u + v > 1.0 + EPS)
        & ~(t < -EPS)
        & (world.valid[None, :] > 0.0)
    )
    t_masked = jnp.where(accept, t, F_MAX)
    idx = jnp.argmin(t_masked, axis=1)
    best_t = jnp.take_along_axis(t_masked, idx[:, None], axis=1)[:, 0]
    return best_t, idx


def mxu_chunk_size(n_tris: int, budget: int = 1 << 28) -> int:
    """Rays per ``trace_mxu`` chunk: the largest power of two up to 8192
    whose (chunk, T) f32 products stay within ``budget`` elements (1 GiB
    each), so the plain sweep fits device memory at any scene size."""
    chunk = 8192
    while chunk > 128 and chunk * n_tris > budget:
        chunk //= 2
    return chunk


def hits_at(world: WorldTriangles, t: jax.Array, idx: jax.Array) -> HitRecord:
    """HitRecord of the triangles ``idx`` hit at distances ``t`` (a miss is
    ``t == FLOAT_MAX``; its ``idx`` may be any valid row)."""
    hit = t < F_MAX
    return HitRecord(
        t=t,
        normal=jnp.where(hit[:, None], world.shade_normal[idx], 0.0),
        mat_type=jnp.where(hit, world.mat_type[idx], 0),
        mat_color=jnp.where(hit[:, None], world.mat_color[idx], 0.0),
        geom_normal=jnp.where(
            hit[:, None], normalize_guarded(world.plane_n[idx]), 0.0
        ),
        mat_ri=(
            jnp.where(hit, world.mat_ri[idx], 1.5)
            if world.mat_ri is not None
            else None
        ),
    )


def nearest_mxu(
    world: WorldTriangles, ro: jax.Array, rd_n: jax.Array, chunk_size: int | None = None
):
    """``(t (N,), idx (N,))`` of the plain sweep over ``chunk_size``-ray
    chunks (default :func:`mxu_chunk_size`); ``rd_n`` normalized."""
    n = ro.shape[0]
    if chunk_size is None:
        chunk_size = mxu_chunk_size(world.num_triangles)
    if n <= chunk_size:
        return _trace_chunk(world, ro, rd_n)
    n_pad = _round_up(n, chunk_size)
    ro_p = jnp.pad(ro, ((0, n_pad - n), (0, 0)))
    rd_p = jnp.pad(rd_n, ((0, n_pad - n), (0, 0)), constant_values=1.0)
    ro_c = ro_p.reshape(-1, chunk_size, 3)
    rd_c = rd_p.reshape(-1, chunk_size, 3)
    t, idx = jax.lax.map(lambda args: _trace_chunk(world, *args), (ro_c, rd_c))
    return t.reshape(-1)[:n], idx.reshape(-1)[:n]


def trace_mxu(
    world: WorldTriangles, ro: jax.Array, rd: jax.Array, chunk_size: int | None = None
) -> HitRecord:
    """Full-scene nearest-hit for a wavefront of world-space rays.

    Equivalent in results to ``computeRaySceneIntersectionKernel``
    (``Renderer.cpp:363-409``) minus the DDA early-exit quirk (this engine
    always returns the true nearest hit).
    """
    t, idx = nearest_mxu(world, ro, normalize(rd), chunk_size)
    return hits_at(world, t, idx)
