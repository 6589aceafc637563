"""Native (C++) host-runtime parity tests.

The native library (native/ptap_native.cc) must produce bit-identical
outputs to the pure-Python implementations it accelerates: the OBJ loader
(io/obj.py), the uniform-grid builder (scene/grid.py) and the BMP writer
(io/bmp.py).  Either side serves as the oracle for the other.
"""

import os

import numpy as np
import pytest

from pathtracerap import native
from pathtracerap.io.bmp import read_bmp, write_bmp
from pathtracerap.io.obj import load_obj
from pathtracerap.scene.build import default_asset_dir
from pathtracerap.scene.grid import build_uniform_grid

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (g++/make missing)"
)

_REF_OBJS = [
    os.path.join(default_asset_dir(), n)
    for n in ("enclosing_box.obj", "ceiling_light.obj", "blender_monkey.obj")
]


@pytest.mark.parametrize("path", _REF_OBJS, ids=[os.path.basename(p) for p in _REF_OBJS])
def test_obj_native_matches_python(path):
    if not os.path.exists(path):
        pytest.skip("reference assets not mounted")
    py = load_obj(path, backend="python")
    nat = load_obj(path, backend="native")
    np.testing.assert_array_equal(nat.triangles, py.triangles)
    np.testing.assert_array_equal(nat.positions, py.positions)
    np.testing.assert_array_equal(nat.normals, py.normals)
    np.testing.assert_array_equal(nat.uvs, py.uvs)
    np.testing.assert_array_equal(nat.bbox_min, py.bbox_min)
    np.testing.assert_array_equal(nat.bbox_max, py.bbox_max)


def test_obj_native_rejects_quads(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    with pytest.raises(ValueError):
        load_obj(str(p), backend="native")
    p2 = tmp_path / "missing.obj"
    with pytest.raises(ValueError):
        load_obj(str(p2), backend="native")


def test_obj_native_negative_indices_and_vt(tmp_path):
    p = tmp_path / "neg.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vt 0.25 0.5\nvt 0.75 0.5\nvt 0.5 1.0\n"
        "vn 0 0 1\n"
        "f -3/-3/-1 -2/-2/-1 -1/-1/-1\n"
    )
    py = load_obj(str(p), backend="python")
    nat = load_obj(str(p), backend="native")
    np.testing.assert_array_equal(nat.triangles, py.triangles)
    np.testing.assert_array_equal(nat.positions, py.positions)
    np.testing.assert_array_equal(nat.normals, py.normals)
    np.testing.assert_array_equal(nat.uvs, py.uvs)


@pytest.mark.parametrize("seed,dims", [(0, (25, 25, 25)), (1, (7, 5, 3)), (2, (25, 25, 25))])
def test_grid_native_matches_python(seed, dims):
    rng = np.random.default_rng(seed)
    t = int(rng.integers(50, 400))
    centers = rng.uniform(-10, 10, (t, 1, 3)).astype(np.float32)
    offsets = rng.uniform(-1.5, 1.5, (t, 3, 3)).astype(np.float32)
    tv = centers + offsets
    bbmin = tv.reshape(-1, 3).min(axis=0)
    bbmax = tv.reshape(-1, 3).max(axis=0)
    py = build_uniform_grid(tv, bbmin, bbmax, dims, tri_index_base=17, backend="python")
    nat = build_uniform_grid(tv, bbmin, bbmax, dims, tri_index_base=17, backend="native")
    np.testing.assert_array_equal(nat.voxel_width, py.voxel_width)
    np.testing.assert_array_equal(nat.voxel_tri_start, py.voxel_tri_start)
    np.testing.assert_array_equal(nat.voxel_tri_count, py.voxel_tri_count)
    np.testing.assert_array_equal(nat.tri_indices, py.tri_indices)


def test_grid_native_empty_and_degenerate():
    tv = np.zeros((0, 3, 3), np.float32)
    py = build_uniform_grid(tv, np.zeros(3), np.ones(3), (4, 4, 4), backend="python")
    nat = build_uniform_grid(tv, np.zeros(3), np.ones(3), (4, 4, 4), backend="native")
    np.testing.assert_array_equal(nat.voxel_tri_count, py.voxel_tri_count)
    assert nat.tri_indices.size == 0
    # planar mesh: zero-extent axis must not divide by zero
    tvp = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    pyp = build_uniform_grid(tvp, tvp.reshape(-1, 3).min(0), tvp.reshape(-1, 3).max(0),
                             (4, 4, 4), backend="python")
    natp = build_uniform_grid(tvp, tvp.reshape(-1, 3).min(0), tvp.reshape(-1, 3).max(0),
                              (4, 4, 4), backend="native")
    np.testing.assert_array_equal(natp.voxel_tri_start, pyp.voxel_tri_start)
    np.testing.assert_array_equal(natp.tri_indices, pyp.tri_indices)


@pytest.mark.parametrize("parity,w,h", [(True, 10, 7), (False, 10, 7), (True, 4, 4), (False, 5, 3)])
def test_bmp_native_byte_identical(tmp_path, parity, w, h):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    p_py = tmp_path / "py.bmp"
    p_nat = tmp_path / "nat.bmp"
    write_bmp(str(p_py), img, parity=parity, backend="python")
    write_bmp(str(p_nat), img, parity=parity, backend="native")
    assert p_py.read_bytes() == p_nat.read_bytes()
    np.testing.assert_array_equal(read_bmp(str(p_nat), parity=parity), img)
