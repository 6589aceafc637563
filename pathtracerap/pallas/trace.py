"""Nearest-hit traversal kernel for the GPU (Pallas, lowered by Triton).

The plain XLA sweep (``ops/plucker._trace_chunk``) materializes four
(rays x triangles) f32 products in device memory before its min/argmin
reduction.  This kernel fuses the whole nearest-hit reduction: one program
owns a tile of ``ray_tile`` rays, keeps their Pluecker coordinates and the
running best (t, index) in registers, and reads only triangles.

Culling is a per-tile worklist built outside the kernel by cheap XLA slab
tests (:func:`_tile_block_lists`): the blocks of ``tri_block`` Morton-sorted
triangles that any live ray of the tile can reach, sorted front to back by
the tile's AABB entry distance and padded with -1.  A program walks its own
row; per block it sweeps the triangles in ``chunk``-wide column slices,
evaluating the three Pluecker sides and the plane distance as IEEE f32
broadcast FMAs (K = 6 gives the tensor cores nothing to do, and TF32 would
flip accepts).  Because the row is sorted by entry distance, the walk stops
at the first block whose entry distance exceeds every live ray's current
best — the wavefront analog of the reference's DDA early exit
(``Renderer.cpp:326-329``), but conservative: it never changes the result.
A tile with no live ray has an empty row and exits at once.

Numerical semantics are those of ``ops/plucker._trace_chunk``: the same
EPSILON-guarded accept chain (``Renderer.cpp:188-201``) and exact-t ties
resolved to the lowest triangle index, whatever the visit order.

The kernel compiles for the GPU only.  Anywhere else it runs in the Pallas
interpreter, and only inside :func:`interpret_mode`; otherwise it raises.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import constants
from ..ops.math import normalize
from ..ops.plucker import hits_at
from ..scene.types import WorldTriangles

F_MAX = constants.FLOAT_MAX
EPS = constants.EPSILON

# Launch shape, chosen on an H100 SXM (400 W limit) from a sweep of
# (ray_tile, chunk, warps) in {16..128} x {32..128} x {2, 4, 8} on the
# reference scene's 800k-ray primary wavefront (PERF.md).
RAY_TILE = 32  # rays per program (a power of two)
TRI_CHUNK = 32  # triangle columns per inner step (a power of two)
NUM_WARPS = 2
NUM_STAGES = 2


_interpret = False


@contextlib.contextmanager
def interpret_mode(on: bool = True):
    """Run the kernel in the Pallas interpreter inside this block.  The
    mode is read when a caller is traced, so a function jitted inside the
    block keeps it."""
    global _interpret
    old, _interpret = _interpret, bool(on)
    try:
        yield
    finally:
        _interpret = old


def _check_backend() -> None:
    """Raise when the kernel would have to run outside the interpreter on
    a backend it cannot compile for."""
    if not _interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the pallas traversal kernel compiles only for the GPU; on the "
            f"{jax.default_backend()!r} backend enter "
            "pathtracerap.pallas.trace.interpret_mode()"
        )


def _nearest_hit_kernel(
    len_ref,  # (nt,) i32 — worklist length per tile
    list_ref,  # (nt, L) i32 — block ids, front to back, -1 padded
    lim_ref,  # (nt, L) f32 — entry distance of each listed block, minus margin
    ray_ref,  # (10, N) f32 — [dir, orig x dir, orig, alive]
    tri_ref,  # (22, T) f32 — WorldTriangles.tri_pack
    t_out,  # (N,) f32
    idx_out,  # (N,) i32
    *,
    ray_tile: int,
    chunk: int,
    tri_block: int,
):
    i = pl.program_id(0)
    rows = pl.ds(pl.multiple_of(i * ray_tile, ray_tile), ray_tile)
    w = [ray_ref[k, rows][:, None] for k in range(6)]
    o = [ray_ref[6 + k, rows][:, None] for k in range(3)]
    live = ray_ref[9, rows] > 0.0
    n_visit = len_ref[i]
    n_list = list_ref.shape[1]

    def sweep_chunk(blk, c, carry):
        best_t, best_i = carry
        base = blk * tri_block + c * chunk
        cols = pl.ds(pl.multiple_of(base, chunk), chunk)

        def row(k):
            return tri_ref[k, cols][None, :]

        def side(e):
            r = 6 * e
            s = w[0] * row(r)
            for k in range(1, 6):
                s = s + w[k] * row(r + k)
            return s  # (ray_tile, chunk)

        s_ab, s_bc, s_ca = side(0), side(1), side(2)
        det = s_ab + s_bc + s_ca  # = dir . n
        parallel = det == 0.0
        inv_det = 1.0 / jnp.where(parallel, 1.0, det)
        u = s_ca * inv_det
        v = s_ab * inv_det
        o_dot_n = o[0] * row(18) + o[1] * row(19) + o[2] * row(20)
        t = (row(21) - o_dot_n) * inv_det
        accept = (
            ~parallel
            & ~(u < -EPS)
            & ~(u > 1.0 + EPS)
            & ~(v < -EPS)
            & ~(u + v > 1.0 + EPS)
            & ~(t < -EPS)
        )
        t_m = jnp.where(accept, t, F_MAX)
        c_min = jnp.min(t_m, axis=1)
        c_arg = jnp.argmin(t_m, axis=1).astype(jnp.int32) + base
        # lexicographic (t, idx): exact-t ties resolve to the lowest
        # triangle index whatever order the blocks are visited in
        improve = (c_min < best_t) | (
            (c_min == best_t) & (c_arg < best_i) & (c_min < F_MAX)
        )
        return jnp.where(improve, c_min, best_t), jnp.where(improve, c_arg, best_i)

    def more(carry):
        j, best_t, _ = carry
        reach = jnp.max(jnp.where(live, best_t, -jnp.inf))
        lim = lim_ref[i, jnp.minimum(j, n_list - 1)]
        return (j < n_visit) & (lim <= reach)

    def visit(carry):
        j, best_t, best_i = carry
        blk = list_ref[i, j]
        best_t, best_i = jax.lax.fori_loop(
            0, tri_block // chunk, functools.partial(sweep_chunk, blk),
            (best_t, best_i),
        )
        return j + 1, best_t, best_i

    _, best_t, best_i = jax.lax.while_loop(
        more,
        visit,
        (
            jnp.int32(0),
            jnp.full((ray_tile,), F_MAX, jnp.float32),
            jnp.full((ray_tile,), -1, jnp.int32),
        ),
    )
    t_out[rows] = best_t
    idx_out[rows] = best_i


# Above this many blocks the per-ray slab pass materializes (N, nb, 3)
# tensors measured in GB — switch to the O(nt * nb) per-tile frustum
# interval test instead.
FRUSTUM_LIST_THRESHOLD = 48


def _tile_block_lists(
    block_aabb: jax.Array,  # (nb, 8)
    ro: jax.Array,  # (N, 3) padded to tile multiple
    rd_n: jax.Array,  # (N, 3) normalized
    alive: jax.Array,  # (N, 1) f32
    ray_tile: int,
    margin=None,
) -> tuple[jax.Array, jax.Array]:
    """Per ray tile, the blocks any live ray's slab test can reach.

    Returns ``(lists, keys)``, both (nt, nb): block ids sorted by the
    tile's min entry distance and -1 padded, and those entry distances
    (``inf`` on padding).  Two builders with identical contracts
    (conservative: never drops a block a live ray could hit, and a key
    never exceeds the entry distance of any member ray):

    * ``nb <= FRUSTUM_LIST_THRESHOLD`` — exact per-ray slab tests, tile-min
      reduced.  Cost O(N * nb) elementwise.
    * larger — per-tile interval-arithmetic frustum test: the tile's rays
      are summarized by an origin AABB and a per-axis direction interval;
      the slab test is evaluated over those intervals, which bounds every
      member ray's test from both sides.  Cost O(nt * nb), independent of
      the ray count.
    """
    if margin is None:
        margin = _slab_margin(block_aabb)
    nb = block_aabb.shape[0]
    nt = ro.shape[0] // ray_tile
    bmin = block_aabb[:, 0:3]
    bmax = block_aabb[:, 3:6]
    small = jnp.abs(rd_n) < 1e-12
    inv_d = 1.0 / jnp.where(small, jnp.where(rd_n < 0.0, -1e-12, 1e-12), rd_n)

    if nb <= FRUSTUM_LIST_THRESHOLD:
        lo = (bmin[None, :, :] - ro[:, None, :]) * inv_d[:, None, :]  # (N, nb, 3)
        hi = (bmax[None, :, :] - ro[:, None, :]) * inv_d[:, None, :]
        tmin = jnp.max(jnp.minimum(lo, hi), axis=-1)  # (N, nb)
        tmax = jnp.min(jnp.maximum(lo, hi), axis=-1)
        hit = (tmax >= -margin) & (tmin <= tmax + margin) & (alive > 0.0)
        key = jnp.where(hit, tmin, jnp.inf).reshape(nt, ray_tile, nb).min(axis=1)
    else:
        # live-ray-only tile summaries (dead lanes would blow up the boxes)
        live = (alive > 0.0).reshape(nt, ray_tile, 1)
        ro_t = ro.reshape(nt, ray_tile, 3)
        iv_t = inv_d.reshape(nt, ray_tile, 3)
        o_lo = jnp.min(jnp.where(live, ro_t, jnp.inf), axis=1)  # (nt, 3)
        o_hi = jnp.max(jnp.where(live, ro_t, -jnp.inf), axis=1)
        i_lo = jnp.min(jnp.where(live, iv_t, jnp.inf), axis=1)
        i_hi = jnp.max(jnp.where(live, iv_t, -jnp.inf), axis=1)
        any_live = jnp.any(live, axis=1)  # (nt, 1)
        # interval products: t_axis = (b - o) * inv_d over o in [o_lo, o_hi],
        # inv_d in [i_lo, i_hi]; evaluate all 4 corner products per bound.
        # An axis whose inv_d interval spans +-inf (mixed-sign directions in
        # the tile) conservatively yields [-inf, +inf], never a false skip.
        def corners(b):  # (nb, 3) plane coords -> (nt, nb, 3, 2, 2)
            d = (
                b[None, :, :, None]
                - jnp.stack([o_lo, o_hi], -1)[:, None, :, :]
            )  # (nt, nb, 3, 2)
            iv = jnp.stack([i_lo, i_hi], -1)[:, None, :, :]  # (nt, 1, 3, 2)
            return d[..., :, None] * iv[..., None, :]  # (nt, nb, 3, 2, 2)

        def minmax(b):
            c = corners(b).reshape(nt, nb, 3, 4)
            # 0 * inf = NaN poisons min/max toward "always reachable":
            # replace NaN by +-inf on the safe side
            return (
                jnp.min(jnp.where(jnp.isnan(c), -jnp.inf, c), axis=-1),
                jnp.max(jnp.where(jnp.isnan(c), jnp.inf, c), axis=-1),
            )

        lo_n_lo, lo_n_hi = minmax(bmin)  # t at the min-plane, per axis bounds
        hi_n_lo, hi_n_hi = minmax(bmax)
        # per-axis slab entry/exit intervals (near = min of the two plane
        # hits, far = max), bounded below/above over the whole frustum
        near_lo = jnp.minimum(lo_n_lo, hi_n_lo)  # (nt, nb, 3)
        far_hi = jnp.maximum(lo_n_hi, hi_n_hi)
        # lower bound of tmin = max over axes of the near lower bounds;
        # upper bound of tmax = min over axes of the far upper bounds
        tmin_lb = jnp.max(near_lo, axis=-1)  # (nt, nb)
        tmax_ub = jnp.min(far_hi, axis=-1)
        hit = (tmax_ub >= -margin) & (tmin_lb <= tmax_ub + margin) & any_live
        # Ring-baked padding blocks carry NaN AABBs (ops/plucker.py).  The
        # exact branch above rejects them for free (NaN comparisons are
        # false), but here the NaN corner products were just replaced by
        # +-inf "on the safe side", which turns padding into an always-hit
        # block with key=-inf — it would sort to the FRONT of every
        # worklist and break the "-1 padding at the END" invariant.
        # Exclude padding rows explicitly.
        valid = ~jnp.isnan(block_aabb[:, 0])
        hit = hit & valid[None, :]
        key = jnp.where(hit, tmin_lb, jnp.inf)

    order = jnp.argsort(key, axis=1).astype(jnp.int32)
    skey = jnp.take_along_axis(key, order, axis=1)
    return jnp.where(jnp.isfinite(skey), order, -1), skey


def _slab_margin(block_aabb: jax.Array) -> jax.Array:
    """Scale-relative conservative slab-test margin (scalar, traced).

    Must cover (a) the reference's tiny-negative-t accepts (``t >= -EPS``,
    an absolute constant, Renderer.cpp:201) and (b) f32 slab arithmetic
    error, which grows with coordinate magnitude — so the margin scales
    with the scene extent instead of being a fixed world-unit constant.
    """
    finite = jnp.abs(block_aabb[:, 0:6]) < F_MAX
    scale = jnp.max(jnp.where(finite, jnp.abs(block_aabb[:, 0:6]), 0.0))
    return EPS + 1e-5 * scale


def nearest_hit(
    tri_pack: jax.Array,  # (22, T)
    block_aabb: jax.Array,  # (nb, 8), nb * tri_block <= T
    tri_block: int,
    ro: jax.Array,  # (N, 3)
    rd_n: jax.Array,  # (N, 3) normalized
    alive: jax.Array | None = None,  # (N,) bool
    *,
    ray_tile: int = RAY_TILE,
    chunk: int = TRI_CHUNK,
):
    """``(t (N,), idx (N,))``: per ray the nearest accepted triangle of the
    pack, ``t == FLOAT_MAX`` and ``idx == -1`` on a miss.  Rays that are
    not ``alive`` take part in no worklist; their result is meaningless
    unless a live ray of their tile reaches the same blocks.  ``ray_tile``
    and ``chunk`` (powers of two) default to the tuned launch shape."""
    _check_backend()
    assert tri_block % chunk == 0, (tri_block, chunk)
    n = ro.shape[0]
    alive_f = (
        jnp.ones((n,), jnp.float32) if alive is None else alive.astype(jnp.float32)
    )
    pad = (-n) % ray_tile
    ro_p = jnp.pad(ro, ((0, pad), (0, 0)))
    rd_p = jnp.pad(rd_n, ((0, pad), (0, 0)), constant_values=1.0)
    alive_p = jnp.pad(alive_f, (0, pad))[:, None]
    n_pad = n + pad
    nt = n_pad // ray_tile

    margin = _slab_margin(block_aabb)
    lists, keys = _tile_block_lists(block_aabb, ro_p, rd_p, alive_p, ray_tile, margin)
    lens = jnp.sum((lists >= 0).astype(jnp.int32), axis=1)
    rays = jnp.concatenate(
        [rd_p, jnp.cross(ro_p, rd_p), ro_p, alive_p], axis=1
    ).T  # (10, N)

    t, idx = pl.pallas_call(
        functools.partial(
            _nearest_hit_kernel, ray_tile=ray_tile, chunk=chunk, tri_block=tri_block
        ),
        grid=(nt,),
        out_shape=[
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=_interpret,
        name="nearest_hit",
    )(lens, lists, keys - margin, rays, tri_pack)
    return t[:n], idx[:n]


def trace_pallas(
    world: WorldTriangles,
    ro: jax.Array,
    rd: jax.Array,
    alive=None,
    return_idx: bool = False,
):
    """Full-scene nearest hit via the kernel; same result contract as
    ``ops.plucker.trace_mxu``.  ``alive`` (N,) bool keeps terminated lanes
    out of the worklists, so tiles with no live ray do no work — the
    wavefront analog of the reference's stream compaction shrinking its
    launch sizes (Renderer.cpp:628-634)."""
    t, idx = nearest_hit(
        world.tri_pack, world.block_aabb, world.tri_block, ro, normalize(rd),
        alive,
    )
    idx = jnp.maximum(idx, 0)
    rec = hits_at(world, t, idx)
    if return_idx:
        return rec, idx
    return rec
