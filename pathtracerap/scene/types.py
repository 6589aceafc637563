"""Scene data model.

The reference's pointer-soup of POD structs + unified-memory pools
(``Primitive.h:14-178``, ``GPUMemoryPool.h:10-46``, ``Renderer.h:19-44``)
becomes two representations here:

* :class:`SceneHost` — numpy structure-of-arrays built on the host by
  :mod:`pathtracerap.scene.build`; the analog of ``Scene``'s public
  vectors (``Scene.h:24-32``) plus the flattened CSR grid layout of
  ``Scene.cpp:377-394``.
* :class:`SceneDevice` — a JAX pytree of device arrays (what
  ``Renderer::allocateOnGPU`` + ``GPUMemoryPool`` did with cudaMallocManaged,
  ``Renderer.cpp:65-130``, is simply ``jax.device_put`` of this pytree; XLA
  owns the buffers).
* :class:`WorldTriangles` — the world-space triangle soup used by the
  Pluecker traversal engines: all model instances baked into world space
  with per-triangle Pluecker edge coordinates, plane equations and flat
  shading normals.  This representation has no analog in the reference; it
  turns a ray/triangle candidate test into a K=6 dot product, which the
  ``mxu`` engine evaluates as XLA matrix products and the ``pallas``
  kernel as broadcast FMAs.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass, static_field


class MaterialType(enum.IntEnum):
    """Material enum; values match the reference order (``Primitive.h:70-79``).

    SPECULAR and REFRACTIVE are declared by the reference but never shaded
    (``Renderer.cpp:433-467`` has no branch for them); we keep the slots for
    table-compatibility and shade them as DIFFUSE-like no-ops is *not* done —
    they fall through unshaded exactly like the reference (ray survives with
    unchanged direction until bounces run out).
    """

    DIFFUSE = 0
    SPECULAR = 1
    REFLECTIVE = 2
    REFRACTIVE = 3
    EMISSIVE = 4
    COAT = 5
    METAL = 6


@dataclasses.dataclass
class Material:
    material_type: MaterialType
    color: tuple
    refractive_index: float = 1.0
    reflectivity: float = 0.0


@dataclasses.dataclass
class SceneHost:
    """Host-side scene: numpy SoA mirroring ``Scene``'s pools.

    Geometry pools are in model space (already scaled by BASE_MODEL_SCALE at
    import, ``Scene.cpp:255-262``).  Grid layout is the reference's flattened
    CSR (``Scene.cpp:377-394``) plus a padded ELL view for vectorized
    traversal.
    """

    # geometry pools
    vertex_pos: np.ndarray  # (V, 3) f32
    vertex_nrm: np.ndarray  # (V, 3) f32
    tri_vidx: np.ndarray  # (T, 3) i32

    # mesh table
    mesh_tri_start: np.ndarray  # (M,) i32
    mesh_tri_end: np.ndarray  # (M,) i32
    mesh_bbox_min: np.ndarray  # (M, 3) f32
    mesh_bbox_max: np.ndarray  # (M, 3) f32

    # model (instance) table
    model_mesh: np.ndarray  # (I,) i32
    model_grid: np.ndarray  # (I,) i32
    model_to_world: np.ndarray  # (I, 4, 4) f32
    world_to_model: np.ndarray  # (I, 4, 4) f32
    mat_type: np.ndarray  # (I,) i32
    mat_color: np.ndarray  # (I, 3) f32
    mat_refractive_index: np.ndarray  # (I,) f32
    mat_reflectivity: np.ndarray  # (I,) f32

    # uniform grids, one per unique mesh that at least one model references
    grid_mesh: np.ndarray  # (G,) i32 mesh index
    grid_voxel_start: np.ndarray  # (G,) i32 offset into voxel pool
    grid_voxel_width: np.ndarray  # (G, 3) f32
    voxel_tri_start: np.ndarray  # (NV,) i32 CSR start into per_voxel_tris
    voxel_tri_count: np.ndarray  # (NV,) i32
    per_voxel_tris: np.ndarray  # (P,) i32 triangle indices (global)
    voxel_tris_ell: np.ndarray  # (NV, K) i32, padded with -1
    grid_dims: tuple = (25, 25, 25)

    @property
    def num_models(self) -> int:
        return int(self.model_mesh.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.tri_vidx.shape[0])

    def world_instance_maps(self, align: int = 128):
        """Static index maps enumerating every (model, mesh triangle) pair.

        ``world_tri_src[k]`` is the global triangle index (−1 for padding)
        and ``world_tri_model[k]`` the model instance for world triangle
        ``k``.  Each model's range is padded to a multiple of ``align`` so
        the 128-triangle runs of the soup never span two model
        instances (cluster AABBs stay tight).
        """
        srcs, mdls = [], []
        for i in range(self.num_models):
            mi = int(self.model_mesh[i])
            ts, te = int(self.mesh_tri_start[mi]), int(self.mesh_tri_end[mi])
            n = te - ts
            pad = (-n) % align
            srcs.append(np.arange(ts, te, dtype=np.int32))
            srcs.append(np.full(pad, -1, dtype=np.int32))
            mdls.append(np.full(n + pad, i, dtype=np.int32))
        return np.concatenate(srcs), np.concatenate(mdls)

    def to_device(self) -> "SceneDevice":
        as_jnp = lambda a: jnp.asarray(a)
        world_tri_src, world_tri_model = self.world_instance_maps()
        return SceneDevice(
            world_tri_src=as_jnp(world_tri_src),
            world_tri_model=as_jnp(world_tri_model),
            vertex_pos=as_jnp(self.vertex_pos),
            vertex_nrm=as_jnp(self.vertex_nrm),
            tri_vidx=as_jnp(self.tri_vidx),
            mesh_bbox_min=as_jnp(self.mesh_bbox_min),
            mesh_bbox_max=as_jnp(self.mesh_bbox_max),
            model_mesh=as_jnp(self.model_mesh),
            model_grid=as_jnp(self.model_grid),
            model_to_world=as_jnp(self.model_to_world),
            world_to_model=as_jnp(self.world_to_model),
            mat_type=as_jnp(self.mat_type),
            mat_color=as_jnp(self.mat_color),
            mat_refractive_index=as_jnp(
                np.asarray(self.mat_refractive_index, np.float32)
            ),
            grid_mesh=as_jnp(self.grid_mesh),
            grid_voxel_start=as_jnp(self.grid_voxel_start),
            grid_voxel_width=as_jnp(self.grid_voxel_width),
            voxel_tri_start=as_jnp(self.voxel_tri_start),
            voxel_tri_count=as_jnp(self.voxel_tri_count),
            per_voxel_tris=as_jnp(self.per_voxel_tris),
            voxel_tris_ell=as_jnp(self.voxel_tris_ell),
            grid_dims=tuple(self.grid_dims),
            n_world_valid=int((world_tri_src >= 0).sum()),
        )


@pytree_dataclass
class SceneDevice:
    """Device pytree of the host scene (model-space geometry + grids)."""

    vertex_pos: jax.Array
    vertex_nrm: jax.Array
    tri_vidx: jax.Array
    mesh_bbox_min: jax.Array
    mesh_bbox_max: jax.Array
    model_mesh: jax.Array
    model_grid: jax.Array
    model_to_world: jax.Array
    world_to_model: jax.Array
    mat_type: jax.Array
    mat_color: jax.Array
    grid_mesh: jax.Array
    grid_voxel_start: jax.Array
    grid_voxel_width: jax.Array
    voxel_tri_start: jax.Array
    voxel_tri_count: jax.Array
    per_voxel_tris: jax.Array
    voxel_tris_ell: jax.Array
    world_tri_src: jax.Array  # (Tw,) i32 global triangle per world instance tri
    world_tri_model: jax.Array  # (Tw,) i32 owning model instance
    # per-model-instance index of refraction (Primitive.h:73 carries it in
    # the data model; quality-mode REFRACTIVE shading reads it, r5).  None
    # for legacy constructions => all materials treated as ior 1.5.
    mat_refractive_index: jax.Array | None = None
    grid_dims: tuple = static_field((25, 25, 25))
    # number of REAL instanced triangles in world_tri_src (entries >= 0) — a
    # static count the bake uses to drop pure-padding traversal blocks
    # (see WorldTriangles); 0 means unknown (legacy construction)
    n_world_valid: int = static_field(0)

    @property
    def num_models(self) -> int:
        return self.model_mesh.shape[0]


@pytree_dataclass
class WorldTriangles:
    """World-space baked triangle soup for the Pluecker traversal engines.

    The triangle axis is padded (to a multiple of ``tri_block``); padding
    rows have ``valid == 0`` and zero geometry, so their determinant is 0
    and every engine rejects them.

    Layout for the side tests: edge-major ``(3, 6, T)`` — one
    ``W (N, 6) @ (6, T)`` product per triangle edge, where
    ``W = [dir, orig x dir]`` per ray and each triangle edge (p, q)
    contributes a column ``[m_e; d_e]`` with ``m_e = p x q``,
    ``d_e = q - p``, for directed edges (a,b), (b,c), (c,a).
    """

    edge_pluecker: jax.Array  # (3, 6, T) f32
    plane_n: jax.Array  # (T, 3) f32 geometric normal (b-a) x (c-a)
    plane_d: jax.Array  # (T,) f32   dot(n, a)
    shade_normal: jax.Array  # (T, 3) f32 normalized averaged vertex normal (world)
    mat_type: jax.Array  # (T,) i32
    mat_color: jax.Array  # (T, 3) f32
    valid: jax.Array  # (T,) f32 1.0 for real triangles, 0.0 for padding
    v0: jax.Array  # (T, 3) f32 one vertex per triangle (for grads / rebaking)
    e1: jax.Array  # (T, 3) f32 b - a
    e2: jax.Array  # (T, 3) f32 c - a
    # Row-major operand pack of the traversal kernel (pallas/trace.py):
    # rows [ab(0:6) | bc(6:12) | ca(12:18)] are the three Pluecker edge
    # columns of ``edge_pluecker``, rows 18:21 the plane normal, row 21
    # ``plane_d``.  A kernel program loads one row slice per operand, so a
    # chunk of triangles is 22 contiguous loads.
    tri_pack: jax.Array | None = None  # (22, T) f32
    # Per-block AABBs of ``tri_block`` consecutive (Morton-sorted)
    # triangles, rows [min xyz, max xyz, 0, 0], inflated by the EPSILON
    # accept slack.  Only blocks holding real triangles are kept, except
    # in a ring bake, whose padding blocks are NaN rows (never selected).
    block_aabb: jax.Array | None = None  # (nb, 8) f32
    # Material-slot indirection for the differentiable replay: per-triangle
    # owning model instance + the (M, 3) model color table (the same leaf as
    # ``scene.mat_color``).  ``hit_from_index`` fetches hit colors as
    # ``one_hot(tri_model[idx]) @ mat_table``, whose VJP is another product
    # instead of a scatter-add over every ray.  Forward values are
    # identical: ``mat_color`` is baked as exactly ``mat_table[tri_model]``.
    tri_model: jax.Array | None = None  # (T,) i32
    mat_table: jax.Array | None = None  # (M, 3) f32
    # (T,) f32 per-triangle index of refraction (quality-mode REFRACTIVE
    # shading)
    mat_ri: jax.Array | None = None
    # Static block geometry: ``tri_block`` is the block width of
    # ``block_aabb``; ``n_valid`` the real-triangle count (soup order puts
    # them first).
    tri_block: int = static_field(0)
    n_valid: int = static_field(0)

    @property
    def num_triangles(self) -> int:
        return self.valid.shape[0]
