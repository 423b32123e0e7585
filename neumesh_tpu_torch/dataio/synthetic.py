"""Synthetic scaffolds (own copy of neumesh_tpu/dataio/synthetic.py's
icosphere_mesh)."""
from __future__ import annotations

import numpy as np

from ..mesh.triangle_mesh import TriangleMesh


def icosphere_mesh(radius: float = 0.5, subdivisions: int = 5):
    """Subdivided-icosahedron sphere: uniform vertex density (unlike the
    UV sphere, whose pole clustering is pathological for spatial indexing).
    subdivisions=5 -> 10242 verts, 6 -> 40962 verts."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key in edge_mid:
                return edge_mid[key]
            m = verts_list[a] + verts_list[b]
            m = m / np.linalg.norm(m)
            verts_list.append(m)
            edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    mesh = TriangleMesh(verts * radius, faces)
    normals = mesh.compute_vertex_normals()
    if np.mean(np.sum(normals * mesh.vertices, axis=-1)) < 0:
        mesh.triangles = mesh.triangles[:, ::-1].copy()
        mesh.compute_vertex_normals()
    return mesh
