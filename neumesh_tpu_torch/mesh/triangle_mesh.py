"""Host-side triangle mesh container and PLY IO (own copy of the parts of
neumesh_tpu/mesh/triangle_mesh.py the port needs). Pure numpy."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class TriangleMesh:
    vertices: np.ndarray                       # (N, 3) float
    triangles: np.ndarray                      # (M, 3) int
    vertex_normals: Optional[np.ndarray] = None
    vertex_colors: Optional[np.ndarray] = None  # (N, 3) float in [0, 1]
    vertex_uvs: Optional[np.ndarray] = None     # (N, 2) float

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float64)
        self.triangles = np.ascontiguousarray(self.triangles, dtype=np.int64)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def n_triangles(self) -> int:
        return len(self.triangles)

    # ------------------------------------------------------------------
    def compute_vertex_normals(self) -> np.ndarray:
        """Area-weighted accumulation of face normals, then normalised
        (Open3D ComputeVertexNormals semantics; reference
        models/mesh_grid.py:20)."""
        v = self.vertices
        t = self.triangles
        fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
        normals = np.zeros_like(v)
        for i in range(3):
            np.add.at(normals, t[:, i], fn)
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = normals / np.maximum(norm, 1e-12)
        self.vertex_normals = normals
        return normals


# ---------------------------------------------------------------------------
# PLY IO
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> TriangleMesh:
    """PLY reader: ascii 1.0 and binary_little_endian 1.0; vertex props
    x/y/z [nx/ny/nz] [red/green/blue] [s/t|u/v], face vertex lists."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype) or list-prop])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.strip().decode("ascii", "replace").split()
            if not tokens or tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append([tokens[1], int(tokens[2]), []])
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append(
                        ("list", tokens[4], _PLY_TYPES[tokens[2]],
                         _PLY_TYPES[tokens[3]]))
                else:
                    elements[-1][2].append((tokens[2], _PLY_TYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        data = {}
        if fmt == "ascii":
            for name, count, props in elements:
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                data[name] = (_parse_ascii(rows, props), props)
        elif fmt == "binary_little_endian":
            for name, count, props in elements:
                if any(p[0] == "list" for p in props):
                    data[name] = (_parse_binary_list(f, count, props), props)
                else:
                    dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                    arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                    data[name] = (
                        {p[0]: arr[p[0]] for p in props}, props)
        else:
            raise ValueError(f"unsupported PLY format: {fmt}")

    vd = data.get("vertex", ({}, []))[0]
    verts = np.stack([vd["x"], vd["y"], vd["z"]], axis=-1).astype(np.float64)
    mesh_kwargs = {}
    if "nx" in vd:
        mesh_kwargs["vertex_normals"] = np.stack(
            [vd["nx"], vd["ny"], vd["nz"]], -1).astype(np.float64)
    if "red" in vd:
        colors = np.stack([vd["red"], vd["green"], vd["blue"]], -1)
        if colors.dtype.kind in "ui":
            colors = colors.astype(np.float64) / 255.0
        mesh_kwargs["vertex_colors"] = colors
    for u_key, v_key in (("s", "t"), ("u", "v")):
        if u_key in vd and v_key in vd:
            mesh_kwargs["vertex_uvs"] = np.stack(
                [vd[u_key], vd[v_key]], -1).astype(np.float64)
            break

    tris = np.zeros((0, 3), np.int64)
    if "face" in data:
        fl = data["face"][0].get("vertex_indices",
                                 data["face"][0].get("vertex_index"))
        tris = np.asarray(fl, dtype=np.int64)

    return TriangleMesh(vertices=verts, triangles=tris, **mesh_kwargs)


def _parse_ascii(rows, props):
    out = {}
    has_list = any(p[0] == "list" for p in props)
    if has_list:
        lists = [np.array([int(x) for x in row[1:1 + int(row[0])]])
                 for row in rows]
        name = props[0][1] if props[0][0] == "list" else "vertex_indices"
        out[name] = np.stack(lists) if lists else np.zeros((0, 3), np.int64)
        return out
    cols = np.array([[float(x) for x in row] for row in rows])
    for j, p in enumerate(props):
        out[p[0]] = cols[:, j] if len(cols) else np.zeros((0,))
    return out


def _parse_binary_list(f, count, props):
    # only the common case: a single list property (face vertex_indices)
    assert len(props) == 1 and props[0][0] == "list"
    _, name, count_t, item_t = props[0]
    count_dt = np.dtype("<" + count_t)
    item_dt = np.dtype("<" + item_t)
    faces = []
    for _ in range(count):
        n = int(np.frombuffer(f.read(count_dt.itemsize), count_dt)[0])
        idx = np.frombuffer(f.read(item_dt.itemsize * n), item_dt)
        faces.append(idx.astype(np.int64))
    if faces and all(len(x) == 3 for x in faces):
        arr = np.stack(faces)
    else:
        # triangulate polygon fans
        tri = []
        for fidx in faces:
            for i in range(1, len(fidx) - 1):
                tri.append([fidx[0], fidx[i], fidx[i + 1]])
        arr = np.asarray(tri, dtype=np.int64)
    return {name: arr}


def save_ply(mesh: TriangleMesh, path: str, binary: bool = True) -> None:
    n, m = mesh.n_vertices, mesh.n_triangles
    props = ["property float x", "property float y", "property float z"]
    cols = [mesh.vertices.astype(np.float32)]
    if mesh.vertex_normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(mesh.vertex_normals.astype(np.float32))
    if mesh.vertex_uvs is not None:
        props += ["property float s", "property float t"]
        cols.append(mesh.vertex_uvs.astype(np.float32))
    has_color = mesh.vertex_colors is not None
    if has_color:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    header = (
        "ply\n"
        + ("format binary_little_endian 1.0\n" if binary
           else "format ascii 1.0\n")
        + f"element vertex {n}\n" + "\n".join(props) + "\n"
        + f"element face {m}\n"
        + "property list uchar int vertex_indices\n"
        + "end_header\n")

    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        vdata = np.concatenate(cols, axis=-1)
        if has_color:
            rgb = np.clip(mesh.vertex_colors * 255.0, 0, 255).astype(np.uint8)
        if binary:
            fields = [("xyz", "<f4", vdata.shape[1])]
            if has_color:
                fields.append(("rgb", "u1", 3))
            rec = np.zeros(n, dtype=np.dtype(fields))
            rec["xyz"] = vdata
            if has_color:
                rec["rgb"] = rgb
            f.write(rec.tobytes())
            frec = np.zeros(
                m, dtype=np.dtype([("n", "u1"), ("idx", "<i4", 3)]))
            frec["n"] = 3
            frec["idx"] = mesh.triangles.astype(np.int32)
            f.write(frec.tobytes())
        else:
            for i in range(n):
                row = " ".join(f"{x:.8g}" for x in vdata[i])
                if has_color:
                    row += " " + " ".join(str(int(x)) for x in rgb[i])
                f.write((row + "\n").encode("ascii"))
            for i in range(m):
                f.write((f"3 {mesh.triangles[i, 0]} {mesh.triangles[i, 1]} "
                         f"{mesh.triangles[i, 2]}\n").encode("ascii"))


def load_obj(path: str) -> TriangleMesh:
    """Minimal OBJ reader (v / f; polygon faces fan-triangulated)."""
    verts, faces = [], []
    with open(path, "r", encoding="utf8", errors="replace") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                idx = [int(x.split("/")[0]) - 1 for x in t[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return TriangleMesh(np.asarray(verts), np.asarray(faces, dtype=np.int64))


def load_mesh(path: str) -> TriangleMesh:
    if path.endswith(".obj"):
        return load_obj(path)
    return load_ply(path)
