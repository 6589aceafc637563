"""Scene layer tests: OBJ loading, grid build, reference scene assembly."""

import numpy as np
import pytest

from pathtracerap import constants
from pathtracerap.io.obj import load_obj
from pathtracerap.scene.build import (
    default_asset_dir,
    build_cornell_box_scene,
    build_reference_scene,
    rotation_y_matrix,
    trs,
)
from pathtracerap.scene.grid import build_uniform_grid, grids_to_ell

import os

ASSET_DIR = default_asset_dir()
HAVE_ASSETS = os.path.isdir(ASSET_DIR)
needs_assets = pytest.mark.skipif(not HAVE_ASSETS, reason="reference assets not mounted")


@needs_assets
def test_load_monkey_obj():
    mesh = load_obj(os.path.join(ASSET_DIR, "blender_monkey.obj"))
    # 967 pre-triangulated faces (SURVEY.md C19)
    assert mesh.num_triangles == 967
    # positions scaled by BASE_MODEL_SCALE (Scene.cpp:255-262)
    assert np.abs(mesh.positions).max() > 100.0
    # every face-corner has a normal
    assert np.all(np.linalg.norm(mesh.normals, axis=1) > 0)
    # bbox contains all vertices
    assert np.all(mesh.positions >= mesh.bbox_min - 1e-3)
    assert np.all(mesh.positions <= mesh.bbox_max + 1e-3)


@needs_assets
def test_load_box_obj_counts():
    mesh = load_obj(os.path.join(ASSET_DIR, "enclosing_box.obj"))
    assert mesh.num_triangles == 60  # SURVEY.md C19: 60 faces
    light = load_obj(os.path.join(ASSET_DIR, "ceiling_light.obj"))
    assert light.num_triangles == 12


def test_obj_rejects_quads(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    with pytest.raises(ValueError):
        load_obj(str(p))


def test_grid_single_triangle_stamps_expected_voxels():
    # One triangle spanning the low-x half of a unit cube mesh AABB.
    tri = np.array([[[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.5, 0.0]]], np.float32)
    g = build_uniform_grid(tri, np.zeros(3), np.ones(3), dims=(4, 4, 4))
    # triangle AABB = [0, .5]x[0, .5]x[0,0] -> voxels x 0..2, y 0..2, z 0
    # (hi index = floor(0.5 / 0.25) = 2, conservative stamp Scene.cpp:300-315)
    nx = 3
    occupied = np.nonzero(g.voxel_tri_count)[0]
    expect = sorted(x + y * 4 for x in range(nx) for y in range(nx))
    assert sorted(occupied.tolist()) == expect
    assert g.tri_indices.shape[0] == nx * nx


def test_grid_csr_matches_bucket_semantics():
    rng = np.random.default_rng(0)
    verts = rng.uniform(-1, 1, size=(50, 3, 3)).astype(np.float32)
    bb_min = verts.reshape(-1, 3).min(axis=0)
    bb_max = verts.reshape(-1, 3).max(axis=0)
    g = build_uniform_grid(verts, bb_min, bb_max, dims=(5, 5, 5))

    # Oracle: direct transliteration of the reference's scalar bucket loop
    # (Scene.cpp:349-375).
    dims = np.array([5, 5, 5])
    width = (bb_max - bb_min) / dims
    buckets = [[] for _ in range(125)]
    for t in range(50):
        t_min = verts[t].min(axis=0)
        t_max = verts[t].max(axis=0)
        lo = np.clip(np.floor(np.abs(bb_min - t_min) / width).astype(int), 0, dims - 1)
        hi = np.clip(np.floor(np.abs(bb_min - t_max) / width).astype(int), 0, dims - 1)
        for z in range(lo[2], hi[2] + 1):
            for y in range(lo[1], hi[1] + 1):
                for x in range(lo[0], hi[0] + 1):
                    buckets[x + y * 5 + z * 25].append(t)

    for v in range(125):
        s, c = g.voxel_tri_start[v], g.voxel_tri_count[v]
        assert g.tri_indices[s : s + c].tolist() == buckets[v]


def test_ell_round_trip():
    starts = np.array([0, 2, 2, 5], np.int32)
    counts = np.array([2, 0, 3, 1], np.int32)
    pool = np.array([7, 8, 1, 2, 3, 9], np.int32)
    ell = grids_to_ell(starts, counts, pool, pad_multiple=4)
    assert ell.shape == (4, 4)
    assert ell[0].tolist() == [7, 8, -1, -1]
    assert ell[1].tolist() == [-1, -1, -1, -1]
    assert ell[2].tolist() == [1, 2, 3, -1]
    assert ell[3].tolist() == [9, -1, -1, -1]


@needs_assets
def test_reference_scene_structure():
    scene = build_reference_scene()
    # 11 active models (Scene.cpp:32-221), 3 meshes, 3 grids
    assert scene.num_models == 11
    assert scene.mesh_tri_start.shape[0] == 3
    assert scene.grid_mesh.shape[0] == 3
    assert scene.num_triangles == 60 + 12 + 967
    # instances of the same mesh share one grid (Scene.cpp:320-333)
    # mesh 1 (ceiling_light) backs 3 stands + 4 lights = 7 instances
    light_instances = np.nonzero(scene.model_mesh == 1)[0]
    assert len(light_instances) == 7
    assert len(set(scene.model_grid[light_instances].tolist())) == 1
    # voxel pool: 3 grids x 25^3 voxels
    assert scene.voxel_tri_start.shape[0] == 3 * 25 ** 3
    # transforms invert each other
    for i in range(11):
        np.testing.assert_allclose(
            scene.model_to_world[i] @ scene.world_to_model[i],
            np.eye(4),
            atol=1e-4,
        )
    # material sanity: 4 emissive lights
    assert (scene.mat_type == 4).sum() == 4


def test_trs_matches_glm_convention():
    # T * R * S applies scale first, then rotation, then translation.
    m = trs((1.0, 2.0, 3.0), 90.0, (2.0, 2.0, 2.0))
    p = np.array([1.0, 0.0, 0.0, 1.0])
    out = m @ p
    # scale -> (2,0,0); rot y 90deg -> (0,0,-2); translate -> (1,2,1)
    np.testing.assert_allclose(out[:3], [1.0, 2.0, 1.0], atol=1e-6)


def test_rotation_y_matches_glm():
    r = rotation_y_matrix(90.0)
    np.testing.assert_allclose(r[:3, :3] @ np.array([0, 0, 1.0]), [1, 0, 0], atol=1e-12)


def test_cornell_scene_builds():
    scene = build_cornell_box_scene()
    assert scene.num_models == 4
    assert scene.num_triangles == 36
    dev = scene.to_device()
    assert dev.num_models == 4
