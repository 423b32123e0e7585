"""ctypes bindings of the host-geometry library (cpp/src/host_lib.cpp):
marching tetrahedra and cubes, an exact KD-tree kNN, a BVH ray caster and
ARAP deformation, with the wrappers and dtype conversions of
neumesh_tpu/cpp/native.py (the port's own copy of both).

The library is built by g++ at first use into build/neumesh_tpu_torch/
(ops/_build.py::build_host). Nothing falls back: a failed build or load
raises, with the compiler's output.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..ops import _build

_LIB = None
_LOCK = threading.Lock()


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build.build_host())
            _configure(lib)
            _LIB = lib
        return _LIB


def _configure(lib):
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    for prefix in ("mt", "mc"):
        fn = getattr(lib, prefix + "_extract")
        fn.restype = ctypes.c_longlong
        fn.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.POINTER(ctypes.c_void_p)]
        fn = getattr(lib, prefix + "_get_results")
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, f64p, i64p]
        fn = getattr(lib, prefix + "_free")
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p]
        fn = getattr(lib, prefix + "_num_tris")
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_void_p]

    lib.kdtree_build.restype = ctypes.c_void_p
    lib.kdtree_build.argtypes = [f64p, ctypes.c_longlong]
    lib.kdtree_free.restype = None
    lib.kdtree_free.argtypes = [ctypes.c_void_p]
    lib.kdtree_knn.restype = None
    lib.kdtree_knn.argtypes = [
        ctypes.c_void_p, f64p, ctypes.c_longlong, ctypes.c_int, i64p, f64p]

    lib.bvh_build.restype = ctypes.c_void_p
    lib.bvh_build.argtypes = [f64p, ctypes.c_longlong, i64p,
                              ctypes.c_longlong]
    lib.bvh_free.restype = None
    lib.bvh_free.argtypes = [ctypes.c_void_p]
    lib.bvh_cast.restype = None
    lib.bvh_cast.argtypes = [
        ctypes.c_void_p, f64p, f64p, ctypes.c_longlong, f64p, i64p]

    lib.arap_deform.restype = ctypes.c_int
    lib.arap_deform.argtypes = [
        f64p, ctypes.c_longlong, i64p, ctypes.c_longlong,
        i64p, f64p, ctypes.c_longlong, ctypes.c_int, f64p]


def available() -> bool:
    """True once the library is built and loaded (a failure raises)."""
    return _load() is not None


def _extract_iso(field: np.ndarray, iso: float, prefix: str):
    lib = _load()
    nx, ny, nz = field.shape
    # the extractors dedup crossed edges with a (lo << 32) | hi key
    if nx * ny * nz >= 2**32:
        raise ValueError(
            f"{prefix}_extract: grid {nx}x{ny}x{nz} has >= 2^32 vertices; "
            "the packed edge-dedup key would collide (split the grid)")
    handle = ctypes.c_void_p()
    n_verts = getattr(lib, prefix + "_extract")(
        np.ascontiguousarray(field, np.float32), nx, ny, nz,
        ctypes.c_float(iso), ctypes.byref(handle))
    if n_verts < 0:
        raise RuntimeError(prefix + "_extract failed")
    n_tris = getattr(lib, prefix + "_num_tris")(handle)
    verts = np.empty((n_verts, 3), np.float64)
    tris = np.empty((n_tris, 3), np.int64)
    if n_verts:
        getattr(lib, prefix + "_get_results")(handle, verts, tris)
    getattr(lib, prefix + "_free")(handle)
    return verts, tris


def marching_tetrahedra(field: np.ndarray, iso: float):
    """Grid-space (vertices (V, 3) float64, triangles (T, 3) int64) of the
    iso level set, each cell split into 6 tetrahedra."""
    return _extract_iso(field, iso, "mt")


def marching_cubes(field: np.ndarray, iso: float):
    """Classic marching cubes (one vertex per crossed grid edge): the
    PyMCubes-comparable vertex set (reference extract_mesh.py:139)."""
    return _extract_iso(field, iso, "mc")


class KDTree:
    """Exact kNN over a fixed point set in float64 (threaded queries); of
    equal distances it keeps the first it visits."""

    def __init__(self, points: np.ndarray):
        self._lib = _load()
        self._pts = np.ascontiguousarray(points, np.float64).reshape(-1, 3)
        self._h = self._lib.kdtree_build(self._pts, len(self._pts))

    def query(self, q: np.ndarray, k: int = 1):
        """(distance (Q, k) float64 ascending, index (Q, k) int64); inf / -1
        past the number of points."""
        q = np.ascontiguousarray(q, np.float64).reshape(-1, 3)
        n = len(q)
        idx = np.empty((n, k), np.int64)
        dist = np.empty((n, k), np.float64)
        self._lib.kdtree_knn(self._h, q, n, k, idx, dist)
        return dist, idx

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.kdtree_free(self._h)
            self._h = None


class BVH:
    """Ray-triangle casting (Open3D RaycastingScene analog; reference
    models/mesh_grid.py:22-39)."""

    def __init__(self, vertices: np.ndarray, triangles: np.ndarray):
        self._lib = _load()
        self._v = np.ascontiguousarray(vertices, np.float64).reshape(-1, 3)
        self._t = np.ascontiguousarray(triangles, np.int64).reshape(-1, 3)
        if len(self._t) and (self._t.min() < 0
                             or self._t.max() >= len(self._v)):
            raise ValueError("BVH: triangle vertex id out of range")
        self._h = self._lib.bvh_build(self._v, len(self._v), self._t,
                                      len(self._t))

    def cast(self, rays_o: np.ndarray, rays_d: np.ndarray):
        """(t_hit (N,) float64, primitive id (N,) int64); inf / -1 on a
        miss."""
        rays_o = np.ascontiguousarray(rays_o, np.float64).reshape(-1, 3)
        rays_d = np.ascontiguousarray(rays_d, np.float64).reshape(-1, 3)
        if rays_o.shape != rays_d.shape:
            raise ValueError("BVH.cast: rays_o and rays_d differ in shape")
        n = len(rays_o)
        t_hit = np.empty(n, np.float64)
        prim = np.empty(n, np.int64)
        self._lib.bvh_cast(self._h, rays_o, rays_d, n, t_hit, prim)
        return t_hit, prim

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bvh_free(self._h)
            self._h = None


def arap(vertices: np.ndarray, triangles: np.ndarray,
         constraint_ids: np.ndarray, constraint_pos: np.ndarray,
         max_iter: int = 20) -> np.ndarray:
    """As-rigid-as-possible deformation (Open3D
    deform_as_rigid_as_possible analog; reference
    editing/render_texture_swapping.py:56-59): (N, 3) float64 vertices
    with constraint_ids pinned at constraint_pos."""
    lib = _load()
    v = np.ascontiguousarray(vertices, np.float64).reshape(-1, 3)
    t = np.ascontiguousarray(triangles, np.int64).reshape(-1, 3)
    cid = np.ascontiguousarray(constraint_ids, np.int64).reshape(-1)
    cpos = np.ascontiguousarray(constraint_pos, np.float64).reshape(-1, 3)
    if len(cid) != len(cpos):
        raise ValueError("arap: one position per constraint id")
    if len(t) and (t.min() < 0 or t.max() >= len(v)):
        raise ValueError("arap: triangle vertex id out of range")
    out = np.empty_like(v)
    rc = lib.arap_deform(v, len(v), t, len(t), cid, cpos, len(cid),
                         int(max_iter), out)
    if rc != 0:
        raise ValueError(f"arap_deform failed rc={rc} (a constraint id "
                         "out of range)")
    return out
