"""Generate the committed high-poly OBJ asset for BASELINE config 2.

The upstream Stanford bunny is git-LFS-missing in the reference
(`/root/reference/PathTracerAP/.MISSING_LARGE_BLOBS`), so the suite's
"dense OBJ mesh" config uses a generated organic stand-in: a sphere
displaced by a few spherical harmonics-ish lobes (~73k triangles), with
smooth area-weighted vertex normals, written through the same
``io.obj.save_obj`` / ``load_obj`` pair the framework uses for real assets.

Authored at ~0.1 world units so the reference's BASE_MODEL_SCALE=1000
import scaling (Scene.cpp:255-262) lands it at ~100 render units.
"""
import sys

sys.path.insert(0, "/root/repo")

import numpy as np

from pathtracerap.io.obj import ObjMesh, save_obj
from pathtracerap.scene.build import make_sphere_mesh

SUBDIV = 192  # 2 * SUBDIV^2 = 73,728 triangles


def main(out="assets/meshes/highpoly_blob.obj"):
    base = make_sphere_mesh(radius=1.0, subdiv=SUBDIV)
    pos = np.asarray(base.positions, dtype=np.float64)
    r = np.linalg.norm(pos, axis=1, keepdims=True)
    u = pos / np.maximum(r, 1e-12)
    x, y, z = u[:, 0], u[:, 1], u[:, 2]
    theta = np.arccos(np.clip(z, -1, 1))
    phi = np.arctan2(y, x)
    disp = (
        1.0
        + 0.18 * np.sin(3.0 * theta) * np.sin(5.0 * phi)
        + 0.12 * np.cos(7.0 * phi) * np.sin(2.0 * theta) ** 2
        + 0.08 * np.sin(11.0 * theta + 2.0 * phi)
    )
    pos = u * (0.08 * disp[:, None])  # ~0.08 authored units

    tris = np.asarray(base.triangles, dtype=np.int64)
    a, b, c = pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]]
    fn = np.cross(b - a, c - a)  # area-weighted face normals
    vn = np.zeros_like(pos)
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)

    mesh = ObjMesh(
        positions=pos.astype(np.float32),
        normals=vn.astype(np.float32),
        uvs=np.zeros((pos.shape[0], 2), np.float32),
        triangles=tris.astype(np.int32),
        bbox_min=pos.min(axis=0).astype(np.float32),
        bbox_max=pos.max(axis=0).astype(np.float32),
    )
    save_obj(out, mesh, header="generated by scripts/make_highpoly_asset.py")
    print(f"wrote {out}: {mesh.num_vertices} verts, {mesh.num_triangles} tris")


if __name__ == "__main__":
    main(*sys.argv[1:])
