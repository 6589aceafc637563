"""Geometry-sharded rendering: triangle shards rotating around a ring.

For scenes too large to replicate per device, the world-space triangle
soup's traversal operands (the kernel pack: 22 floats/tri) are sharded
over the mesh axis; rays stay resident on their home device and the
*triangle shards* rotate around the ring with ``lax.ppermute`` — the
weights-stationary sibling of ring attention (fixed size state circulating
while each device keeps its data shard; SURVEY.md section 5
"long-context analog").  After ``D`` steps every ray
has been tested against every shard and each device holds its rays'
global nearest hit.

Rotating triangles instead of rays is the right direction whenever
``bytes(triangle shard) < bytes(ray block)`` — at the reference workload
(3k triangles vs 100k rays/device) it is ~100x less traffic.

Tie-break is made rotation-order-independent by reducing on the
lexicographic key (t, global triangle id), so results are bit-identical to
the single-device engine whichever device a ray lands on.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .. import constants
from ..ops.math import normalize
from ..ops.plucker import hits_at
from ..scene.types import SceneDevice

F_MAX = constants.FLOAT_MAX


def _ring(n_dev: int):
    return [(i, (i + 1) % n_dev) for i in range(n_dev)]


def make_geometry_sharded_tracer(n_dev: int, axis: str = "shard"):
    """Ring tracer: the kernel pack's triangle shards rotate over the mesh.

    Each device holds ``nb/D`` blocks of the traversal pack
    (``tri_pack`` columns + ``block_aabb`` rows, baked with
    ``ring_shards=D``).  Per rotation step the shard in hand is traced with
    the same entry as the single-device path (``pallas.trace.nearest_hit``,
    which builds its worklists against the shard's own block AABBs), and
    local indices are offset to global ones.

    Returns ``tracer(world_l, ro, rd, alive=None, return_idx=False) ->
    HitRecord`` for use INSIDE shard_map, where ``world_l.tri_pack`` is the
    local (22, T/D) column shard, ``world_l.block_aabb`` the local (nb/D, 8)
    rows (NaN rows for padding blocks — never selected by a worklist), and
    the per-triangle attribute tables (shade_normal / mat_type / mat_color /
    plane_n) are replicated full-length arrays.  The lexicographic
    (t, global idx) reduction makes results bit-identical to the
    replicated engine regardless of rotation order.
    """
    from ..pallas.trace import nearest_hit

    def tracer(world_l, ro, rd, alive=None, return_idx: bool = False):
        rd_n = normalize(rd)
        t_shard = world_l.tri_pack.shape[1]
        none = jnp.iinfo(jnp.int32).max
        best_t = jnp.full((ro.shape[0],), F_MAX, jnp.float32)
        best_idx = jnp.full((ro.shape[0],), none, jnp.int32)

        state = (
            world_l.tri_pack,
            world_l.block_aabb,
            jax.lax.axis_index(axis) * t_shard,
        )
        for _ in range(n_dev):
            pack_s, aabb_s, off = state
            t, idx = nearest_hit(pack_s, aabb_s, world_l.tri_block, ro, rd_n, alive)
            g_idx = jnp.where(idx >= 0, idx + off, none)
            improve = (t < best_t) | (
                (t == best_t) & (t < F_MAX) & (g_idx < best_idx)
            )
            best_t = jnp.where(improve, t, best_t)
            best_idx = jnp.where(improve, g_idx, best_idx)
            state = jax.lax.ppermute(state, axis, _ring(n_dev))

        best_idx = jnp.where(best_t < F_MAX, best_idx, 0)
        rec = hits_at(world_l, best_t, best_idx)
        if return_idx:
            return rec, best_idx
        return rec

    return tracer


def make_ring_diff_tracer(n_dev: int, axis: str = "shard"):
    """Differentiable ring tracer: ring forward (stop-grad), backward
    recomputed at the frozen winning triangle via ``hit_from_index`` on the
    replicated diff tables (v0/e1/e2/tri_model/mat_table) — the ring
    edition of ``diff.fast.trace_pallas_diff``.  Gradients flow to
    ``world.mat_table`` (mat_color/emission) through the one-hot product."""
    from ..diff.fast import hit_from_index

    ring = make_geometry_sharded_tracer(n_dev, axis)

    def tracer(world_l, ro, rd, alive=None):
        rd_n = normalize(rd)
        rec, idx = ring(
            jax.lax.stop_gradient(world_l),
            jax.lax.stop_gradient(ro),
            jax.lax.stop_gradient(rd_n),
            alive=alive,
            return_idx=True,
        )
        hit = rec.t < F_MAX
        return hit_from_index(world_l, ro, rd_n, idx, hit)

    return tracer


def ring_world_specs(world, axis: str = "shard"):
    """PartitionSpecs for a ``ring_shards``-baked world: the traversal
    packs sharded over ``axis``, per-triangle attribute tables replicated."""
    specs = jax.tree_util.tree_map(lambda _: P(), world)
    return specs.replace(
        tri_pack=P(None, axis),
        block_aabb=P(axis, None),
        edge_pluecker=P(None, None, axis),
    )


def render_image_geometry_sharded(
    scene: SceneDevice,
    config,
    mesh: Optional[Mesh] = None,
    tile_size: int = 2048,
):
    """Full render with triangles sharded + rays sharded over one mesh axis.

    Both shardings share the axis: device d owns ray rows d and triangle
    shard d; every trace call runs the D-step ring.
    """
    from ..ops.plucker import bake_world_triangles
    from ..render.camera import generate_rays
    from ..render.wavefront import _render_tile, render_ray_array

    if mesh is None:
        from .sharding import default_mesh

        mesh = default_mesh()
        mesh = Mesh(mesh.devices, ("shard",))
    n_dev = mesh.devices.size

    world = jax.jit(
        functools.partial(bake_world_triangles, ring_shards=n_dev)
    )(scene)
    shard_tracer = make_geometry_sharded_tracer(n_dev)
    world_specs = ring_world_specs(world)

    key = jax.random.PRNGKey(config.seed)
    ro, rd = generate_rays(config.camera, config.resolution)
    n = ro.shape[0]
    per_dev = -(-n // n_dev)
    per_dev = -(-per_dev // tile_size) * tile_size
    n_pad = per_dev * n_dev
    ro = jnp.pad(ro, ((0, n_pad - n), (0, 0)))
    rd = jnp.pad(rd, ((0, n_pad - n), (0, 0)), constant_values=1.0)
    tiles_per_dev = per_dev // tile_size

    def local_render(world_l, key_l, ro_l, rd_l):
        tracer = lambda o, d, alive=None: shard_tracer(world_l, o, d, alive=alive)
        render_tile = functools.partial(
            _render_tile,
            tracer,
            key=key_l,
            n_samples=config.samples_per_pixel,
            max_bounces=config.max_bounces,
            parity=config.parity,
            sample_offset=0,
            scene=scene,
        )
        tile_base = jax.lax.axis_index("shard") * tiles_per_dev
        return render_ray_array(render_tile, ro_l, rd_l, tile_size, tile_base=tile_base)

    shard = jax.shard_map(
        local_render,
        mesh=mesh,
        in_specs=(world_specs, P(), P("shard"), P("shard")),
        out_specs=P("shard"),
        check_vma=False,
    )
    acc = jax.jit(shard)(world, key, ro, rd)[:n]
    w, h = config.resolution
    return acc.reshape(h, w, 3) / config.samples_per_pixel


def make_geometry_sharded_train_step(
    scene: SceneDevice,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    mesh: Mesh,
    lr: float = 0.05,
    tile_size: int = 2048,
    parity: bool = True,
    param_names=("mat_color",),
):
    """Differentiable train step over a geometry-sharded ring.

    Two regimes by ``param_names`` (VERDICT r4 next-round item 5):

    * ``("mat_color",)`` — the heavy traversal packs are baked ONCE
      (frozen, stop-gradient — the ring trace is detached hit topology
      exactly like every other engine); the differentiable material table
      rides as the parameter and is re-injected into the local world each
      step, so mat_color/emission gradients flow through
      :func:`diff.fast.hit_from_index`'s one-hot matmul while triangles
      stay sharded.
    * any geometry parameter (``vertex_pos`` / ``model_to_world``) — the
      world is RE-BAKED from the parameters inside the loss every step
      (``bake_world_triangles(ring_shards=D)``) with its heavy pack
      sharding-constrained back onto the ring axis, so the forward trace
      sees the current geometry and the frozen-topology replay's
      v0/e1/e2/normal tables are differentiable functions of the
      parameters.  Use ``parity=False`` for pixel-loss vertex gradients
      (in parity mode color is a pure albedo product and carries none —
      render/shade.py).

    Returns jitted ``step(params, target_flat, key) -> (loss, new_params)``.
    """
    from ..ops.plucker import bake_world_triangles
    from ..render.camera import generate_rays
    from ..render.wavefront import _render_tile, render_ray_array

    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    rebake = any(name != "mat_color" for name in param_names)
    world = jax.jit(
        functools.partial(bake_world_triangles, ring_shards=n_dev)
    )(scene)
    if not rebake:
        world = jax.lax.stop_gradient(world)
    world_specs = ring_world_specs(world, axis)
    diff_tracer = make_ring_diff_tracer(n_dev, axis)

    ro, rd = generate_rays(camera, resolution)
    n = ro.shape[0]
    per_dev = -(-n // n_dev)
    per_dev = -(-per_dev // tile_size) * tile_size
    n_pad = per_dev * n_dev
    ro = jnp.pad(ro, ((0, n_pad - n), (0, 0)))
    rd = jnp.pad(rd, ((0, n_pad - n), (0, 0)), constant_values=1.0)
    # pad rays (rows >= n) render real content vs a zero target — mask
    # them out of the loss (ADVICE r4)
    w_valid = (jnp.arange(n_pad) < n).astype(jnp.float32)[:, None]
    tiles_per_dev = per_dev // tile_size

    if rebake:
        from jax.sharding import NamedSharding

        shard_tree = jax.tree_util.tree_map(
            lambda spec: NamedSharding(mesh, spec), world_specs
        )

        def local_loss(world_l, target_l, key_l, ro_l, rd_l, w_l):
            tile_base = jax.lax.axis_index(axis) * tiles_per_dev
            tracer = lambda o, d, alive=None: diff_tracer(
                world_l, o, d, alive=alive
            )
            render_tile = functools.partial(
                _render_tile,
                tracer,
                key=key_l,
                n_samples=n_samples,
                max_bounces=max_bounces,
                parity=parity,
                sample_offset=0,
                scene=scene,
            )
            acc = render_ray_array(
                render_tile, ro_l, rd_l, tile_size, tile_base=tile_base
            )
            img = acc / n_samples
            return jax.lax.psum(
                jnp.sum(w_l * (img - target_l) ** 2), axis
            )

        sharded_loss = jax.shard_map(
            local_loss,
            mesh=mesh,
            in_specs=(world_specs, P(axis), P(), P(axis), P(axis), P(axis)),
            out_specs=P(),
            check_vma=False,
        )

        @jax.jit
        def step_rebake(params, target_flat, key):
            t = jnp.pad(
                target_flat, ((0, n_pad - target_flat.shape[0]), (0, 0))
            )

            def loss_fn(p):
                world_p = bake_world_triangles(
                    scene.replace(**p), ring_shards=n_dev
                )
                # pin the heavy pack back onto the ring axis so the bake's
                # output materializes sharded, not replicated
                world_p = jax.lax.with_sharding_constraint(
                    world_p, shard_tree
                )
                return sharded_loss(world_p, t, key, ro, rd, w_valid)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            new_params = jax.tree_util.tree_map(
                lambda q, g: q - lr * g, params, grads
            )
            return loss, new_params

        return step_rebake

    def local_step(params, world_l, target_l, key_l, ro_l, rd_l, w_l):
        tile_base = jax.lax.axis_index(axis) * tiles_per_dev

        def loss_fn(p):
            w = world_l.replace(mat_table=p["mat_color"])
            tracer = lambda o, d, alive=None: diff_tracer(w, o, d, alive=alive)
            render_tile = functools.partial(
                _render_tile,
                tracer,
                key=key_l,
                n_samples=n_samples,
                max_bounces=max_bounces,
                parity=parity,
                sample_offset=0,
                scene=scene,
            )
            acc = render_ray_array(
                render_tile, ro_l, rd_l, tile_size, tile_base=tile_base
            )
            img = acc / n_samples
            return jnp.sum(w_l * (img - target_l) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = jax.lax.psum(loss, axis)
        grads = jax.lax.psum(grads, axis)
        new_params = jax.tree_util.tree_map(
            lambda q, g: q - lr * g, params, grads
        )
        return loss, new_params

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), world_specs, P(axis), P(), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(params, target_flat, key):
        t = jnp.pad(target_flat, ((0, n_pad - target_flat.shape[0]), (0, 0)))
        return sharded(params, world, t, key, ro, rd, w_valid)

    return step
