"""Pallas traversal kernel vs the XLA sweep (``trace_mxu``).

The kernel runs in the Pallas interpreter here (requested by the test
session, ``conftest.py``); the same kernel body compiles through Triton on
the GPU, where ``chip_smoke.py`` compares it with ``trace_mxu`` at full
size.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pathtracerap.ops.plucker import _trace_chunk, bake_world_triangles, trace_mxu
from pathtracerap.ops.math import normalize
from pathtracerap.oracle.reference import tied_hits
from pathtracerap.pallas.trace import interpret_mode, nearest_hit, trace_pallas
from pathtracerap.scene.build import (
    SceneBuilder,
    build_cornell_box_scene,
    make_sphere_mesh,
)
from pathtracerap.scene.types import Material, MaterialType

F_MAX = 9999999.0


@pytest.fixture(scope="module")
def world():
    return bake_world_triangles(build_cornell_box_scene().to_device())


def _random_rays(rng, n, scale=1.0):
    ro = (rng.uniform(-150, 150, size=(n, 3)) * scale).astype(np.float32)
    target = (rng.uniform(-180, 180, size=(n, 3)) * scale).astype(np.float32)
    return ro, (target - ro).astype(np.float32)


def _kernel_vs_reference(world, ro, rd, alive=None, **kw):
    """(t, idx) of the kernel and of the plain sweep, on host."""
    rd_n = normalize(jnp.asarray(rd))
    t_k, i_k = jax.jit(
        lambda w, o, d: nearest_hit(w.tri_pack, w.block_aabb, w.tri_block, o, d,
                                    alive, **kw)
    )(world, jnp.asarray(ro), rd_n)
    t_r, i_r = jax.jit(_trace_chunk)(world, jnp.asarray(ro), rd_n)
    return (np.asarray(t_k), np.asarray(i_k)), (np.asarray(t_r), np.asarray(i_r))


def _assert_same_hits(world, ro, rd, t_k, i_k, t_r, i_r):
    """Same hit/miss mask and t within rtol 1e-4; a ray on an edge two
    triangles share may pick the other one of the two, but only where
    float64 confirms the tie, and on at most one ray of these tests (the
    most any of them sees).  The engines sum the Pluecker products in
    different orders, and for a grazing ray or a small far triangle t is a
    quotient of cancelling sums: they differ by up to ~1e-4 relative there
    (measured on the GPU, PERF.md), while most rays agree to ~1e-7."""
    hit = t_r < F_MAX
    np.testing.assert_array_equal(t_k < F_MAX, hit)
    np.testing.assert_allclose(t_k[hit], t_r[hit], rtol=1e-4)
    flip = hit & (i_k != i_r)
    assert flip.sum() <= 1, flip.sum()
    rd_n = np.asarray(normalize(jnp.asarray(rd)))
    tie, _ = tied_hits(world, ro[flip], rd_n[flip], i_k[flip], i_r[flip])
    assert tie.all()


def test_pallas_matches_mxu_engine(world, rng):
    ro, rd = _random_rays(rng, 640)
    h_ref = jax.jit(lambda w, o, d: trace_mxu(w, o, d))(world, ro, rd)
    h_pal = jax.jit(lambda w, o, d: trace_pallas(w, o, d))(world, ro, rd)

    t_ref = np.asarray(h_ref.t)
    t_pal = np.asarray(h_pal.t)
    np.testing.assert_allclose(t_pal, t_ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(h_pal.mat_type), np.asarray(h_ref.mat_type))
    np.testing.assert_allclose(
        np.asarray(h_pal.normal), np.asarray(h_ref.normal), atol=1e-6
    )


@pytest.mark.parametrize(
    "n, ray_tile, chunk",
    [(77, 32, 64), (1, 32, 64), (300, 16, 32), (300, 64, 128)],
    ids=["ragged", "single_ray", "small_tiles", "large_tiles"],
)
def test_kernel_shapes_match_reference(world, n, ray_tile, chunk):
    """Ray counts that are not a tile multiple, and other (power-of-two)
    tile/chunk widths, give the reference's hits."""
    ro, rd = _random_rays(np.random.default_rng(n), n)
    (t_k, i_k), (t_r, i_r) = _kernel_vs_reference(
        world, ro, rd, ray_tile=ray_tile, chunk=chunk
    )
    assert t_k.shape == (n,) and i_k.shape == (n,)
    _assert_same_hits(world, ro, rd, t_k, i_k, t_r, i_r)
    assert (i_k[t_r >= F_MAX] == -1).all()


def test_dead_tiles_do_no_work(world):
    """A tile with no live ray has an empty worklist: it returns the miss
    sentinel without visiting a block; live rays still get their hits."""
    ro, rd = _random_rays(np.random.default_rng(1), 128)
    alive = np.ones(128, bool)
    alive[:64] = False  # two whole 32-ray tiles dead
    (t_k, i_k), (t_r, i_r) = _kernel_vs_reference(world, ro, rd, jnp.asarray(alive))
    assert (t_k[:64] == F_MAX).all() and (i_k[:64] == -1).all()
    _assert_same_hits(world, ro[64:], rd[64:], t_k[64:], i_k[64:], t_r[64:], i_r[64:])


def test_equal_t_ties_resolve_to_lowest_index():
    """Overlapping duplicate instances hit at bit-equal t: every engine
    returns the lowest triangle index, whatever order the kernel visits
    the (here 64-triangle) blocks in."""
    b = SceneBuilder()
    ball = b.add_mesh(make_sphere_mesh(radius=60.0, subdiv=12))
    for _ in range(4):
        b.add_instance(ball, Material(MaterialType.DIFFUSE, (0.5, 0.5, 0.5)))
    world = bake_world_triangles(b.build().to_device(), tri_block=64)
    assert world.block_aabb.shape[0] >= 8
    rng = np.random.default_rng(2)
    ro = rng.uniform(-200, 200, size=(256, 3)).astype(np.float32)
    rd = (rng.uniform(-20, 20, size=(256, 3)) - ro).astype(np.float32)
    (t_k, i_k), (t_r, i_r) = _kernel_vs_reference(world, ro, rd)
    hit = t_r < F_MAX
    assert hit.mean() > 0.5
    _assert_same_hits(world, ro, rd, t_k, i_k, t_r, i_r)
    # the four copies of a triangle are bit-identical rows: every hit must
    # report the first copy, in both engines
    geo = np.concatenate([np.asarray(world.v0), np.asarray(world.e1),
                          np.asarray(world.e2)], axis=1)
    first = {}
    for row in range(geo.shape[0] - 1, -1, -1):
        first[geo[row].tobytes()] = row
    for idx in (i_k[hit], i_r[hit]):
        lowest = np.array([first[geo[i].tobytes()] for i in idx])
        np.testing.assert_array_equal(idx, lowest)


def _degenerate_rays(world):
    """Rays that stress the det == 0 / grazing accept paths."""
    v0 = np.asarray(world.v0)
    e1 = np.asarray(world.e1)
    e2 = np.asarray(world.e2)
    i = int(np.argmax(np.asarray(world.valid) > 0))
    a, d1, d2 = v0[i], e1[i], e2[i]
    n = np.cross(d1, d2)
    n = n / np.linalg.norm(n)
    ro = [a - 3.0 * d1, a + 0.5 * d1 + 10.0 * n, a + 0.25 * d1 + 0.25 * d2,
          a - 2.0 * d1 + 1e-3 * n, a + 5.0 * n]
    rd = [d1, -n, -n, d1 + 1e-7 * n, 1e-13 * n]
    return np.stack(ro).astype(np.float32), np.stack(rd).astype(np.float32)


def test_grazing_and_in_plane_rays_match_reference(world):
    """det == 0 (in-plane), grazing and on-surface rays: the kernel keeps
    the reference's explicit parallel mask and EPSILON accept chain."""
    ro, rd = _degenerate_rays(world)
    (t_k, i_k), (t_r, i_r) = _kernel_vs_reference(world, ro, rd)
    np.testing.assert_array_equal(t_k < F_MAX, t_r < F_MAX)
    hit = t_r < F_MAX
    np.testing.assert_allclose(t_k[hit], t_r[hit], rtol=1e-5, atol=1e-5)


def test_padding_triangles_are_never_hit(world):
    """Model-alignment and tail padding are zero triangles at the origin;
    rays aimed straight at the origin must never report one."""
    ro = np.random.default_rng(3).uniform(-150, 150, size=(96, 3)).astype(np.float32)
    rd = -ro
    (t_k, i_k), (t_r, _) = _kernel_vs_reference(world, ro, rd)
    valid = np.asarray(world.valid)
    hit = t_k < F_MAX
    assert (valid[i_k[hit]] > 0).all()
    np.testing.assert_array_equal(hit, t_r < F_MAX)


def test_many_block_scene_uses_frustum_worklists():
    """More blocks than FRUSTUM_LIST_THRESHOLD: the per-tile interval
    worklist builder must stay conservative (no false block skips)."""
    from pathtracerap.bench_suite import build_highpoly_scene
    from pathtracerap.pallas.trace import FRUSTUM_LIST_THRESHOLD

    scene = build_highpoly_scene(subdiv=40, use_asset=False).to_device()
    world = bake_world_triangles(scene, tri_block=64)
    assert world.block_aabb.shape[0] > FRUSTUM_LIST_THRESHOLD
    rng = np.random.default_rng(4)
    ro = rng.uniform(-150, 150, size=(192, 3)).astype(np.float32)
    rd = rng.normal(size=(192, 3)).astype(np.float32)
    (t_k, i_k), (t_r, i_r) = _kernel_vs_reference(world, ro, rd)
    _assert_same_hits(world, ro, rd, t_k, i_k, t_r, i_r)


def test_kernel_raises_without_interpret_request_off_gpu(world):
    """No silent interpreter fallback: off the GPU the kernel runs only
    when a caller asks for interpret mode."""
    ro = jnp.zeros((4, 3), jnp.float32)
    rd = jnp.ones((4, 3), jnp.float32)
    with interpret_mode(False):
        with pytest.raises(RuntimeError, match="compiles only for the GPU"):
            trace_pallas(world, ro, rd)
        with interpret_mode():
            rec = trace_pallas(world, ro, rd)
        with pytest.raises(RuntimeError, match="compiles only for the GPU"):
            trace_pallas(world, ro, rd)
    assert rec.t.shape == (4,)


def test_pallas_renderer_end_to_end(rng):
    from pathtracerap.config import CameraConfig, RenderConfig
    from pathtracerap.render.wavefront import Renderer

    scene = build_cornell_box_scene().to_device()
    camera = CameraConfig(
        position=(0.0, 0.0, 150.0),
        plane_x=(-40.0, 40.0),
        plane_y=(-30.0, 30.0),
        plane_z=100.0,
    )
    cfg = dict(resolution=(16, 8), samples_per_pixel=4, max_bounces=3, camera=camera)
    img_p = np.asarray(Renderer(scene, RenderConfig(engine="pallas", **cfg)).render())
    img_m = np.asarray(Renderer(scene, RenderConfig(engine="mxu", **cfg)).render())
    np.testing.assert_allclose(img_p, img_m, atol=1e-5)


@pytest.mark.parametrize("scale", [1e-3, 1e3])
def test_blocked_culling_safe_at_extreme_scene_scales(rng, scale):
    """Culling margins are scale-relative: at millimeter and kilometer
    scene scales the worklist kernel must agree with the dense sweep — no
    false block skips."""
    world = bake_world_triangles(
        build_cornell_box_scene(size=400.0 * scale).to_device()
    )
    ro, rd = _random_rays(rng, 640, scale)

    h_ref = jax.jit(lambda w, o, d: trace_mxu(w, o, d))(world, ro, rd)
    h_pal = jax.jit(lambda w, o, d: trace_pallas(w, o, d))(world, ro, rd)

    t_ref = np.asarray(h_ref.t)
    t_pal = np.asarray(h_pal.t)
    hit_ref = t_ref < F_MAX
    hit_pal = t_pal < F_MAX
    np.testing.assert_array_equal(hit_pal, hit_ref)
    np.testing.assert_allclose(
        t_pal[hit_pal], t_ref[hit_ref], rtol=1e-5, atol=1e-4 * scale
    )
    np.testing.assert_array_equal(
        np.asarray(h_pal.mat_type), np.asarray(h_ref.mat_type)
    )


def test_frustum_worklists_reject_nan_padding_blocks():
    """Ring-baked padding blocks carry NaN AABBs; in the frustum branch
    (nb > FRUSTUM_LIST_THRESHOLD) they must NOT test as always-hit / sort
    to the front — every worklist keeps valid block ids first, -1 padding
    strictly at the END, and keys ascending with the ids."""
    from pathtracerap.pallas.trace import (
        FRUSTUM_LIST_THRESHOLD,
        _tile_block_lists,
    )

    nb = FRUSTUM_LIST_THRESHOLD + 16
    n_real = nb - 24
    k = jax.random.PRNGKey(0)
    lo = jax.random.uniform(k, (nb, 3), minval=-50.0, maxval=40.0)
    hi = lo + 10.0
    aabb = jnp.concatenate([lo, hi, jnp.zeros((nb, 2))], axis=1)
    # NaN out the padding tail, as ops/plucker.py's ring bake does
    aabb = jnp.where(jnp.arange(nb)[:, None] < n_real, aabb, jnp.nan)

    n = 256
    ro = jnp.zeros((n, 3), jnp.float32).at[:, 2].set(150.0)
    kd = jax.random.normal(jax.random.PRNGKey(1), (n, 3))
    rd = kd / jnp.linalg.norm(kd, axis=1, keepdims=True)
    alive = jnp.ones((n, 1), jnp.float32)

    lists, keys = jax.jit(
        lambda: _tile_block_lists(aabb, ro, rd, alive, ray_tile=128)
    )()
    lists, keys = np.asarray(lists), np.asarray(keys)
    assert lists.shape == keys.shape and lists.shape[1] == nb
    # no NaN-padding block id may ever appear
    assert (lists < n_real).all()
    for row, key in zip(lists, keys):
        neg = np.where(row < 0)[0]
        if neg.size:
            assert (row[neg[0]:] == -1).all()
            assert np.isinf(key[neg[0]:]).all()
        live = row >= 0
        assert (np.diff(key[live]) >= 0).all()
        # at least one real block reachable from inside the scene
        assert row[0] >= 0


def test_tied_hits_confirms_only_shared_edge_ties():
    """The float64 tie check behind the kernel comparisons: two picks of a
    ray on the edge two triangles share are a tie; a pick on a parallel
    plane, a coplanar triangle the ray misses, or the neighbour of a ray
    inside its own triangle is not."""
    from types import SimpleNamespace

    corners = np.array([
        [(0, 0, 0), (1, 0, 0), (0, 1, 0)],  # A
        [(1, 0, 0), (0, 1, 0), (1, 1, 0)],  # B: shares A's hypotenuse
        [(0, 0, 5), (1, 0, 5), (0, 1, 5)],  # C: A moved to a parallel plane
        [(10, 10, 0), (11, 10, 0), (10, 11, 0)],  # D: coplanar, far away
    ], np.float32)
    world = SimpleNamespace(v0=corners[:, 0], e1=corners[:, 1] - corners[:, 0],
                            e2=corners[:, 2] - corners[:, 0])
    ro = np.array([(0.5, 0.5, -1.0)] * 3 + [(0.2, 0.2, -1.0)], np.float32)
    rd = np.tile(np.array([(0.0, 0.0, 1.0)], np.float32), (4, 1))
    tie, shared = tied_hits(world, ro, rd, np.zeros(4, int), np.array([1, 2, 3, 1]))
    np.testing.assert_array_equal(tie, [True, False, False, False])
    np.testing.assert_array_equal(shared, [True, False, False, True])
