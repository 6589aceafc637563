"""Scene assembly.

The reference hard-codes its scene as C++ constructor code
(``Scene.cpp:3-224``): 3 meshes, 11 model instances with TRS transforms and
materials.  Here scene construction is *data*: :class:`SceneBuilder`
accumulates meshes and instances and finalizes into the SoA
:class:`~pathtracerap.scene.types.SceneHost`, and
:func:`build_reference_scene` reproduces the reference scene exactly from
that data.  Transform conventions match glm (column vectors,
``model_to_world = T @ R @ S``; ``Scene.cpp:38`` et al.).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import constants
from ..io.obj import ObjMesh, load_obj
from .grid import build_uniform_grid, grids_to_ell
from .types import Material, MaterialType, SceneHost

REFERENCE_ASSET_DIR = "/root/reference/PathTracerAP/Input data"

# Self-contained copies of the benchmark geometry live in the repo
# (assets/meshes, re-exported through io.obj.save_obj); the read-only
# reference checkout is only a fallback, so renders and tests work without
# it mounted.
REPO_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
    "meshes",
)


def default_asset_dir() -> str:
    """Repo-local assets when present, else the reference checkout."""
    if os.path.isdir(REPO_ASSET_DIR):
        return REPO_ASSET_DIR
    return REFERENCE_ASSET_DIR


# ------------------------------------------------------------------ transforms
def scale_matrix(s: Sequence[float]) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def translation_matrix(t: Sequence[float]) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = t
    return m


def rotation_y_matrix(degrees: float) -> np.ndarray:
    r = np.deg2rad(degrees)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def rotation_x_matrix(degrees: float) -> np.ndarray:
    r = np.deg2rad(degrees)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4, dtype=np.float64)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def rotation_z_matrix(degrees: float) -> np.ndarray:
    r = np.deg2rad(degrees)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def trs(translate, rotate_y_deg, scale) -> np.ndarray:
    """glm-style ``T * R * S`` (scale applied first; ``Scene.cpp:38``)."""
    return translation_matrix(translate) @ rotation_y_matrix(rotate_y_deg) @ scale_matrix(scale)


# ------------------------------------------------------------------- builder
class SceneBuilder:
    """Accumulates meshes + instances, finalizes to :class:`SceneHost`."""

    def __init__(self, grid_dims: Tuple[int, int, int] = (25, 25, 25)):
        self.grid_dims = tuple(grid_dims)
        self._meshes: List[ObjMesh] = []
        self._instances: List[dict] = []

    def add_mesh(self, mesh: ObjMesh) -> int:
        self._meshes.append(mesh)
        return len(self._meshes) - 1

    def add_mesh_file(self, path: str, scale: float = constants.BASE_MODEL_SCALE) -> int:
        """Load a mesh file by extension: .obj (io/obj.py) or .ply
        (io/ply.py) — the formats the reference's Assimp-imported asset set
        actually uses (Scene.cpp:226-238; OBJs committed, Stanford scans
        are PLY-native)."""
        if path.lower().endswith(".ply"):
            from ..io.ply import load_ply

            return self.add_mesh(load_ply(path, scale=scale))
        return self.add_mesh(load_obj(path, scale=scale))

    def add_instance(
        self,
        mesh_index: int,
        material: Material,
        transform: Optional[np.ndarray] = None,
        translate=(0.0, 0.0, 0.0),
        rotate_y_deg: float = 0.0,
        scale=(1.0, 1.0, 1.0),
    ) -> int:
        if transform is None:
            transform = trs(translate, rotate_y_deg, scale)
        self._instances.append(
            dict(mesh_index=mesh_index, material=material, transform=np.asarray(transform))
        )
        return len(self._instances) - 1

    def build(self) -> SceneHost:
        if not self._instances:
            raise ValueError("scene has no model instances")

        # --- concatenate mesh geometry into global pools (Scene.cpp:264-291)
        vertex_pos, vertex_nrm, tri_vidx = [], [], []
        mesh_tri_start, mesh_tri_end = [], []
        mesh_bbox_min, mesh_bbox_max = [], []
        v_off = 0
        t_off = 0
        for mesh in self._meshes:
            vertex_pos.append(mesh.positions)
            vertex_nrm.append(mesh.normals)
            tri_vidx.append(mesh.triangles + v_off)
            mesh_tri_start.append(t_off)
            t_off += mesh.num_triangles
            mesh_tri_end.append(t_off)
            mesh_bbox_min.append(mesh.bbox_min)
            mesh_bbox_max.append(mesh.bbox_max)
            v_off += mesh.num_vertices

        vertex_pos = np.concatenate(vertex_pos).astype(np.float32)
        vertex_nrm = np.concatenate(vertex_nrm).astype(np.float32)
        tri_vidx = np.concatenate(tri_vidx).astype(np.int32)
        mesh_tri_start = np.asarray(mesh_tri_start, np.int32)
        mesh_tri_end = np.asarray(mesh_tri_end, np.int32)
        mesh_bbox_min = np.stack(mesh_bbox_min).astype(np.float32)
        mesh_bbox_max = np.stack(mesh_bbox_max).astype(np.float32)

        # --- model table
        n_inst = len(self._instances)
        model_mesh = np.zeros(n_inst, np.int32)
        m2w = np.zeros((n_inst, 4, 4), np.float32)
        w2m = np.zeros((n_inst, 4, 4), np.float32)
        mat_type = np.zeros(n_inst, np.int32)
        mat_color = np.zeros((n_inst, 3), np.float32)
        mat_ri = np.ones(n_inst, np.float32)
        mat_refl = np.zeros(n_inst, np.float32)
        for i, inst in enumerate(self._instances):
            model_mesh[i] = inst["mesh_index"]
            m = np.asarray(inst["transform"], np.float64)
            m2w[i] = m.astype(np.float32)
            # The reference inverts in float32 via glm::inverse (Scene.cpp:39);
            # we invert in float64 then cast, which is strictly more accurate.
            w2m[i] = np.linalg.inv(m).astype(np.float32)
            mat = inst["material"]
            mat_type[i] = int(mat.material_type)
            mat_color[i] = np.asarray(mat.color, np.float32)
            mat_ri[i] = mat.refractive_index
            mat_refl[i] = mat.reflectivity

        # --- grids: one per unique mesh, shared by instances (Scene.cpp:320-333)
        model_grid = np.zeros(n_inst, np.int32)
        grid_of_mesh: dict = {}
        grid_mesh, grid_voxel_start, grid_voxel_width = [], [], []
        voxel_tri_start, voxel_tri_count, per_voxel_tris = [], [], []
        voxel_off = 0
        pool_off = 0
        for i in range(n_inst):
            mi = int(model_mesh[i])
            if mi in grid_of_mesh:
                model_grid[i] = grid_of_mesh[mi]
                continue
            gi = len(grid_mesh)
            grid_of_mesh[mi] = gi
            model_grid[i] = gi

            ts, te = int(mesh_tri_start[mi]), int(mesh_tri_end[mi])
            tri_verts = vertex_pos[tri_vidx[ts:te]]  # (t, 3, 3)
            g = build_uniform_grid(
                tri_verts,
                mesh_bbox_min[mi],
                mesh_bbox_max[mi],
                dims=self.grid_dims,
                tri_index_base=ts,
            )
            grid_mesh.append(mi)
            grid_voxel_start.append(voxel_off)
            grid_voxel_width.append(g.voxel_width)
            voxel_tri_start.append(g.voxel_tri_start + pool_off)
            voxel_tri_count.append(g.voxel_tri_count)
            per_voxel_tris.append(g.tri_indices)
            voxel_off += g.voxel_tri_start.shape[0]
            pool_off += g.tri_indices.shape[0]

        voxel_tri_start = np.concatenate(voxel_tri_start).astype(np.int32)
        voxel_tri_count = np.concatenate(voxel_tri_count).astype(np.int32)
        per_voxel_tris = (
            np.concatenate(per_voxel_tris).astype(np.int32)
            if per_voxel_tris
            else np.zeros(0, np.int32)
        )
        ell = grids_to_ell(voxel_tri_start, voxel_tri_count, per_voxel_tris)

        return SceneHost(
            vertex_pos=vertex_pos,
            vertex_nrm=vertex_nrm,
            tri_vidx=tri_vidx,
            mesh_tri_start=mesh_tri_start,
            mesh_tri_end=mesh_tri_end,
            mesh_bbox_min=mesh_bbox_min,
            mesh_bbox_max=mesh_bbox_max,
            model_mesh=model_mesh,
            model_grid=model_grid,
            model_to_world=m2w,
            world_to_model=w2m,
            mat_type=mat_type,
            mat_color=mat_color,
            mat_refractive_index=mat_ri,
            mat_reflectivity=mat_refl,
            grid_mesh=np.asarray(grid_mesh, np.int32),
            grid_voxel_start=np.asarray(grid_voxel_start, np.int32),
            grid_voxel_width=np.stack(grid_voxel_width).astype(np.float32),
            voxel_tri_start=voxel_tri_start,
            voxel_tri_count=voxel_tri_count,
            per_voxel_tris=per_voxel_tris,
            voxel_tris_ell=ell,
            grid_dims=self.grid_dims,
        )


# ------------------------------------------------------- reference scene data
def build_reference_scene(asset_dir: Optional[str] = None) -> SceneHost:
    """The reference's hard-coded scene, expressed as data.

    3 meshes (enclosing_box, ceiling_light, blender_monkey; ``Scene.cpp:6-16``)
    and 11 active model instances with the exact TRS parameters, colors and
    material types of ``Scene.cpp:32-221`` in the exact push order (which
    fixes model iteration order in the intersector, ``Renderer.cpp:377``).
    """
    if asset_dir is None:
        asset_dir = default_asset_dir()
    b = SceneBuilder()
    box = b.add_mesh_file(os.path.join(asset_dir, "enclosing_box.obj"))
    light = b.add_mesh_file(os.path.join(asset_dir, "ceiling_light.obj"))
    monkey = b.add_mesh_file(os.path.join(asset_dir, "blender_monkey.obj"))

    M = MaterialType
    add = b.add_instance
    # monkey_model (Scene.cpp:32-42)
    add(monkey, Material(M.METAL, (0.001, 0.99, 0.2)),
        translate=(-50.0, -25.0, 150.0), rotate_y_deg=45.0, scale=(0.08, 0.08, 0.08))
    # monkey_model_2 (Scene.cpp:44-54)
    add(monkey, Material(M.COAT, (0.99, 0.99, 0.001)),
        translate=(75.0, 100.0, 0.0), rotate_y_deg=-40.0, scale=(0.1, 0.1, 0.1))
    # monkey_model_3 (Scene.cpp:56-66)
    add(monkey, Material(M.REFLECTIVE, (0.99, 0.99, 0.75)),
        translate=(325.0, 45.0, 0.0), rotate_y_deg=0.0, scale=(0.1, 0.1, 0.1))
    # box_model (Scene.cpp:114-124)
    add(box, Material(M.DIFFUSE, (0.99, 0.99, 0.99)),
        translate=(25.0, -120.0, 0.0), rotate_y_deg=180.0, scale=(0.1, 0.1, 0.1))
    # stand_model (Scene.cpp:139-149)
    add(light, Material(M.DIFFUSE, (0.99, 0.50, 0.60)),
        translate=(325.0, -120.0, 0.0), rotate_y_deg=45.0, scale=(0.1, 0.1, 0.1))
    # stand_model2 (Scene.cpp:151-161)
    add(light, Material(M.COAT, (0.40, 0.10, 0.99)),
        translate=(-225.0, 8.0, 0.0), rotate_y_deg=45.0, scale=(0.1, 0.1, 0.1))
    # stand_model3 (Scene.cpp:163-173)
    add(light, Material(M.METAL, (0.99, 0.05, 0.10)),
        translate=(75.0, -90.0, 0.0), rotate_y_deg=30.0, scale=(0.1, 0.1, 0.1))
    # light_model (Scene.cpp:175-185)
    add(light, Material(M.EMISSIVE, (0.99, 0.99, 0.99)),
        translate=(0.0, 850.0, -100.0), rotate_y_deg=0.0, scale=(0.2, 0.1, 0.2))
    # light_model2 (Scene.cpp:187-197)
    add(light, Material(M.EMISSIVE, (0.99, 0.99, 0.99)),
        translate=(0.0, 375.0, 950.0), rotate_y_deg=0.0, scale=(0.2, 0.2, 0.1))
    # light_model3 (Scene.cpp:199-209)
    add(light, Material(M.EMISSIVE, (0.99, 0.99, 0.99)),
        translate=(-520.0, 375.0, 0.0), rotate_y_deg=0.0, scale=(0.1, 0.2, 0.2))
    # light_model4 (Scene.cpp:211-221)
    add(light, Material(M.EMISSIVE, (0.99, 0.99, 0.99)),
        translate=(550.0, 375.0, 0.0), rotate_y_deg=0.0, scale=(0.1, 0.2, 0.2))

    return b.build()


# -------------------------------------------------- synthetic test scenes
def _quad(v00, v10, v11, v01):
    """Two triangles for a quad, with per-vertex normals from the face."""
    a, b, c, d = (np.asarray(p, np.float32) for p in (v00, v10, v11, v01))
    n = np.cross(b - a, c - a)
    n = n / np.linalg.norm(n)
    pos = np.stack([a, b, c, d])
    nrm = np.tile(n.astype(np.float32), (4, 1))
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return pos, nrm, tris


def make_box_mesh(size=(1.0, 1.0, 1.0), inward: bool = False) -> ObjMesh:
    """Axis-aligned box mesh centered at origin (12 triangles)."""
    sx, sy, sz = (s / 2.0 for s in size)
    c = np.array(
        [[-sx, -sy, -sz], [sx, -sy, -sz], [sx, sy, -sz], [-sx, sy, -sz],
         [-sx, -sy, sz], [sx, -sy, sz], [sx, sy, sz], [-sx, sy, sz]],
        np.float32,
    )
    faces = [
        (c[0], c[1], c[2], c[3]),  # -z
        (c[5], c[4], c[7], c[6]),  # +z
        (c[4], c[0], c[3], c[7]),  # -x
        (c[1], c[5], c[6], c[2]),  # +x
        (c[4], c[5], c[1], c[0]),  # -y
        (c[3], c[2], c[6], c[7]),  # +y
    ]
    pos, nrm, tris = [], [], []
    off = 0
    for quad in faces:
        if inward:
            quad = tuple(reversed(quad))  # flips winding => normals point inward
        p, n, t = _quad(*quad)
        pos.append(p)
        nrm.append(n)
        tris.append(t + off)
        off += 4
    pos = np.concatenate(pos)
    nrm = np.concatenate(nrm)
    tris = np.concatenate(tris).astype(np.int32)
    return ObjMesh(
        positions=pos,
        normals=nrm,
        uvs=np.zeros((pos.shape[0], 2), np.float32),
        triangles=tris,
        bbox_min=pos.min(axis=0),
        bbox_max=pos.max(axis=0),
    )


def make_sphere_mesh(radius: float = 1.0, subdiv: int = 16) -> ObjMesh:
    """UV-sphere triangle mesh centered at origin with smooth normals.

    Realizes the reference's aspirational SPHERE entity
    (``Primitive.h:113`` declares the enum value; ``Config.txt:1-8``
    sketches the config block; neither is implemented there)."""
    n_lat = max(3, subdiv)
    n_lon = max(3, 2 * subdiv)
    theta = np.linspace(0.0, np.pi, n_lat + 1)
    phi = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            if i > 0:
                tris.append((a, b, c))
            if i < n_lat - 1:
                tris.append((b, d, c))
    tris = np.asarray(tris, np.int32)
    pos = pts * np.float32(radius)
    return ObjMesh(
        positions=pos,
        normals=pts.copy(),  # unit sphere normals
        uvs=np.zeros((pos.shape[0], 2), np.float32),
        triangles=tris,
        bbox_min=pos.min(axis=0),
        bbox_max=pos.max(axis=0),
    )


def build_cornell_box_scene(size: float = 400.0) -> SceneHost:
    """Cornell-box-like diffuse test scene (BASELINE.json config 1).

    A large diffuse enclosing box, two diffuse blocks, one emissive ceiling
    panel.  Built from synthetic meshes so tests need no external assets.
    """
    b = SceneBuilder()
    room = b.add_mesh(make_box_mesh((size, size, size)))
    block = b.add_mesh(make_box_mesh((size * 0.15, size * 0.3, size * 0.15)))
    panel = b.add_mesh(make_box_mesh((size * 0.3, size * 0.02, size * 0.3)))

    M = MaterialType
    b.add_instance(room, Material(M.DIFFUSE, (0.85, 0.85, 0.85)))
    b.add_instance(block, Material(M.DIFFUSE, (0.9, 0.2, 0.2)),
                   translate=(-size * 0.2, -size * 0.33, -size * 0.1), rotate_y_deg=20.0)
    b.add_instance(block, Material(M.DIFFUSE, (0.2, 0.9, 0.2)),
                   translate=(size * 0.2, -size * 0.33, size * 0.1), rotate_y_deg=-15.0)
    b.add_instance(panel, Material(M.EMISSIVE, (0.99, 0.99, 0.99)),
                   translate=(0.0, size * 0.48, 0.0))
    return b.build()
