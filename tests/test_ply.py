"""PLY loader: round-trips, format variants, triangulation, scene parity."""

import numpy as np
import pytest

from pathtracerap.io.obj import ObjMesh, load_obj, save_obj
from pathtracerap.io.ply import PlyParseError, load_ply, save_ply
from pathtracerap.scene.build import SceneBuilder, make_box_mesh


@pytest.fixture()
def box():
    return make_box_mesh(size=(2.0, 3.0, 4.0))


def test_binary_roundtrip(tmp_path, box):
    p = str(tmp_path / "m.ply")
    save_ply(p, box, binary=True)
    m = load_ply(p, scale=1.0)
    np.testing.assert_allclose(m.positions, box.positions, rtol=1e-6)
    np.testing.assert_allclose(m.normals, box.normals, rtol=1e-6)
    np.testing.assert_array_equal(m.triangles, box.triangles)


def test_ascii_roundtrip(tmp_path, box):
    p = str(tmp_path / "m.ply")
    save_ply(p, box, binary=False)
    m = load_ply(p, scale=1.0)
    np.testing.assert_allclose(m.positions, box.positions, rtol=1e-5)
    np.testing.assert_array_equal(m.triangles, box.triangles)


def test_scale_matches_obj_loader_semantics(tmp_path, box):
    """Positions AND normals scale by BASE_MODEL_SCALE (Scene.cpp:255-262
    quirk), exactly like io/obj.load_obj."""
    pp = str(tmp_path / "m.ply")
    po = str(tmp_path / "m.obj")
    save_ply(pp, box)
    save_obj(po, box)
    mp = load_ply(pp, scale=250.0)
    mo = load_obj(po, scale=250.0, backend="python")
    np.testing.assert_allclose(mp.positions, mo.positions, rtol=1e-5)
    np.testing.assert_allclose(mp.normals, mo.normals, rtol=1e-4, atol=1e-3)


def test_quad_fan_triangulation(tmp_path):
    """Polygons fan-triangulate (Assimp aiProcess_Triangulate behavior)."""
    p = str(tmp_path / "quad.ply")
    with open(p, "wb") as f:
        f.write(
            b"ply\nformat ascii 1.0\n"
            b"element vertex 4\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"element face 1\n"
            b"property list uchar int vertex_indices\n"
            b"end_header\n"
            b"0 0 0\n1 0 0\n1 1 0\n0 1 0\n"
            b"4 0 1 2 3\n"
        )
    m = load_ply(p, scale=1.0)
    assert m.num_triangles == 2
    np.testing.assert_array_equal(m.triangles, [[0, 1, 2], [0, 2, 3]])


def test_double_precision_and_extra_props(tmp_path):
    """Double coords and unknown per-vertex properties are handled."""
    p = str(tmp_path / "d.ply")
    with open(p, "wb") as f:
        f.write(
            b"ply\nformat ascii 1.0\ncomment scanned\n"
            b"element vertex 3\n"
            b"property double x\nproperty double y\nproperty double z\n"
            b"property uchar red\n"
            b"element face 1\n"
            b"property list uchar int vertex_indices\n"
            b"end_header\n"
            b"0 0 0 255\n1.5 0 0 0\n0 2.5 0 7\n"
            b"3 0 1 2\n"
        )
    m = load_ply(p, scale=2.0)
    np.testing.assert_allclose(
        m.positions, [[0, 0, 0], [3.0, 0, 0], [0, 5.0, 0]], rtol=1e-6
    )


def test_rejects_non_ply(tmp_path):
    p = str(tmp_path / "x.ply")
    with open(p, "w") as f:
        f.write("not a ply\n")
    with pytest.raises(PlyParseError):
        load_ply(p)


def test_out_of_range_face_index(tmp_path):
    p = str(tmp_path / "bad.ply")
    with open(p, "wb") as f:
        f.write(
            b"ply\nformat ascii 1.0\n"
            b"element vertex 3\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"element face 1\nproperty list uchar int vertex_indices\n"
            b"end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 5\n"
        )
    with pytest.raises(PlyParseError):
        load_ply(p)


def test_builder_dispatches_ply(tmp_path, box):
    """SceneBuilder.add_mesh_file loads .ply like .obj; identical scenes."""
    from pathtracerap.scene.types import Material, MaterialType

    pp = str(tmp_path / "m.ply")
    po = str(tmp_path / "m.obj")
    save_ply(pp, box)
    save_obj(po, box)

    def build(path):
        b = SceneBuilder()
        mid = b.add_mesh_file(path, scale=10.0)
        b.add_instance(mid, Material(MaterialType.DIFFUSE, (0.5, 0.5, 0.5)))
        return b.build()

    sp = build(pp)
    so = build(po)
    np.testing.assert_allclose(
        np.asarray(sp.vertex_pos), np.asarray(so.vertex_pos), rtol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(sp.tri_vidx), np.asarray(so.tri_vidx)
    )
