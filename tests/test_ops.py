"""Geometry/sampling kernels vs the scalar NumPy oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pathtracerap import constants
from pathtracerap.ops.intersect import moller_trumbore, slab_test, trace_parity
from pathtracerap.ops.plucker import bake_world_triangles, trace_mxu
from pathtracerap.ops.sampling import coat_scatter, cosine_hemisphere, metal_scatter
from pathtracerap.ops.math import reflect_parity
from pathtracerap.oracle import reference as oracle
from pathtracerap.scene.build import build_cornell_box_scene


@pytest.fixture(scope="module")
def cornell():
    return build_cornell_box_scene()


@pytest.fixture(scope="module")
def cornell_dev(cornell):
    return cornell.to_device()


def random_rays(rng, n, spread=200.0):
    ro = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def test_moller_trumbore_vs_oracle(rng):
    n = 500
    v0 = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(size=(n, 3)).astype(np.float32)
    v2 = v0 + rng.normal(size=(n, 3)).astype(np.float32)
    ro = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    # aim half the rays at (jittered) triangle centroids so the test
    # exercises plenty of accepts, keep the rest fully random
    centroid = (v0 + v1 + v2) / 3.0
    rd = np.where(
        (np.arange(n) % 2 == 0)[:, None],
        centroid - ro + 0.1 * rng.normal(size=(n, 3)),
        rng.normal(size=(n, 3)),
    ).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)

    acc, t = jax.jit(moller_trumbore)(ro, rd, v0, v1, v2)
    acc, t = np.asarray(acc), np.asarray(t)

    hits = 0
    for i in range(n):
        acc_o, t_o = oracle.mt_scalar(ro[i], rd[i], v0[i], v1[i], v2[i])
        assert acc[i] == acc_o, f"ray {i} accept mismatch"
        if acc_o:
            hits += 1
            np.testing.assert_allclose(t[i], t_o, rtol=2e-4, atol=2e-4)
    assert hits > 10  # sanity: the test actually exercised hits


def test_slab_vs_oracle(rng):
    n = 300
    ro, rd = random_rays(rng, n, spread=3.0)
    rd[:20, 0] = 0.0  # exercise the zero-component branches
    bb_min = np.array([-1, -1, -1], np.float32)
    bb_max = np.array([1, 2, 1], np.float32)
    with np.errstate(divide="ignore"):
        inv = (1.0 / rd).astype(np.float32)
    ok, tmin = jax.jit(slab_test)(ro, rd, inv, bb_min, bb_max)
    ok, tmin = np.asarray(ok), np.asarray(tmin)
    for i in range(n):
        ok_o, t_o = oracle.slab_scalar(ro[i], rd[i], inv[i], bb_min, bb_max)
        assert ok[i] == ok_o
        if ok_o:
            np.testing.assert_allclose(tmin[i], t_o, rtol=1e-5, atol=1e-5)


def test_trace_parity_vs_scalar_oracle(cornell, cornell_dev, rng):
    n = 200
    ro = rng.uniform(-150, 150, size=(n, 3)).astype(np.float32)
    target = rng.uniform(-180, 180, size=(n, 3)).astype(np.float32)
    rd = (target - ro).astype(np.float32)

    hits = jax.jit(trace_parity)(cornell_dev, jnp.asarray(ro), jnp.asarray(rd))
    t = np.asarray(hits.t)
    nrm = np.asarray(hits.normal)
    mtype = np.asarray(hits.mat_type)

    agree = 0
    for i in range(n):
        o = oracle.trace_scalar(cornell, ro[i], rd[i])
        if abs(o["t"] - t[i]) < 5e-3 * max(1.0, abs(o["t"])):
            agree += 1
            if o["t"] < constants.FLOAT_MAX:
                assert mtype[i] == o["mat_type"], i
                # f32 (engine) vs f64 (oracle) 3x3 inverse => small slack
                np.testing.assert_allclose(nrm[i], o["normal"], atol=5e-3)
    # float32 voxel-boundary truncation may diverge on a tiny fraction
    assert agree >= n - 2, f"only {agree}/{n} rays agree"


def test_trace_mxu_vs_bruteforce_nearest(cornell, cornell_dev, rng):
    """The mxu engine must return the true nearest hit (no DDA quirk)."""
    n = 100
    ro = rng.uniform(-150, 150, size=(n, 3)).astype(np.float32)
    target = rng.uniform(-180, 180, size=(n, 3)).astype(np.float32)
    rd = (target - ro).astype(np.float32)

    world = bake_world_triangles(cornell_dev)
    hits = jax.jit(lambda w, o, d: trace_mxu(w, o, d))(world, jnp.asarray(ro), jnp.asarray(rd))
    t = np.asarray(hits.t)

    # brute-force nearest over the world-space soup via the scalar M-T oracle
    v0 = np.asarray(world.v0)
    e1 = np.asarray(world.e1)
    e2 = np.asarray(world.e2)
    valid = np.asarray(world.valid) > 0
    rd_n = rd / np.linalg.norm(rd, axis=1, keepdims=True)

    mismatches = 0
    for i in range(n):
        best = constants.FLOAT_MAX
        for k in range(v0.shape[0]):
            if not valid[k]:
                continue
            acc, tk = oracle.mt_scalar(ro[i], rd_n[i], v0[k], v0[k] + e1[k], v0[k] + e2[k])
            if acc and tk < best:
                best = tk
        if not np.isclose(best, t[i], rtol=1e-3, atol=1e-2):
            mismatches += 1
    # Pluecker vs M-T epsilon boundaries may differ on grazing rays
    assert mismatches <= 2, f"{mismatches}/{n} nearest-hit mismatches"


def _uniform_grid_samples(m=64):
    u = (np.arange(m, dtype=np.float32) + 0.5) / m
    return u


def test_cosine_hemisphere_matches_oracle_and_distribution(rng):
    normal = np.array([0.3, 0.8, -0.52], np.float32)
    normal /= np.linalg.norm(normal)
    n = 400
    u0 = rng.uniform(0, 1, n).astype(np.float32)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    nrm = jnp.broadcast_to(jnp.asarray(normal), (n, 3))
    out = np.asarray(cosine_hemisphere(nrm, jnp.asarray(u0), jnp.asarray(u1)))
    for i in range(0, n, 37):
        o = oracle._cosine_hemisphere(normal, u0[i], u1[i])
        np.testing.assert_allclose(out[i], o, atol=1e-5)
    # all in upper hemisphere, unit length, mean cos(theta) ~ 2/3
    cos_t = out @ normal
    assert np.all(cos_t >= -1e-6)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    assert abs(cos_t.mean() - 2.0 / 3.0) < 0.03


def test_metal_scatter_matches_oracle(rng):
    n = 200
    normal = np.array([0.0, 1.0, 0.0], np.float32)
    d = np.array([0.6, -0.64, 0.48], np.float32)
    d /= np.linalg.norm(d)
    u2 = rng.uniform(0, 1, n).astype(np.float32)
    u3 = rng.uniform(0, 1, n).astype(np.float32)
    out = np.asarray(
        metal_scatter(
            jnp.broadcast_to(jnp.asarray(normal), (n, 3)),
            jnp.broadcast_to(jnp.asarray(d), (n, 3)),
            jnp.asarray(u2),
            jnp.asarray(u3),
        )
    )
    for i in range(0, n, 23):
        o = oracle._metal_scatter(normal, d, u2[i], u3[i])
        np.testing.assert_allclose(out[i], o, atol=1e-5)
    # lobe should concentrate around the mirror direction
    mirror = d - 2 * (d @ normal) * normal
    assert (out @ mirror).mean() > 0.9


def test_coat_scatter_roulette_split(rng):
    normal = np.array([0.0, 1.0, 0.0], np.float32)
    d = np.array([0.0, -1.0, 0.0], np.float32)
    n = 100
    u = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    out = np.asarray(
        coat_scatter(
            jnp.broadcast_to(jnp.asarray(normal), (n, 3)),
            jnp.broadcast_to(jnp.asarray(d), (n, 3)),
            jnp.asarray(u[:, 0]),
            jnp.asarray(u[:, 1]),
            jnp.asarray(u[:, 2]),
        )
    )
    mirror = np.asarray(reflect_parity(jnp.asarray(d), jnp.asarray(normal)))
    took_mirror = np.all(np.isclose(out, mirror, atol=1e-6), axis=1)
    np.testing.assert_array_equal(took_mirror, u[:, 0] < 0.5)


def test_reflect_parity_quirk():
    # the reference formula is n - 2 (i.n) n, NOT i - 2 (i.n) n (utility.h:64-69)
    i = jnp.asarray([[1.0, -1.0, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    out = np.asarray(reflect_parity(i, n))
    np.testing.assert_allclose(out, [[0.0, 3.0, 0.0]], atol=1e-6)
