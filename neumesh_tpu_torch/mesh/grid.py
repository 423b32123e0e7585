"""MeshGrid: the mesh scaffold as tensors on the model's device, and the
interpolated signed distance of the per-sample protocol (counterpart of
neumesh_tpu/mesh/grid.py)."""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import interp
from ..ops.knn import CandidateGrid, build_candidate_grid, knn_brute
from .triangle_mesh import TriangleMesh


class MeshGrid:
    """Vertices, vertex normals and the kNN structure on `device`.
    distance_method 'grid': the candidate grid (`grid` adopts tables built
    elsewhere, CandidateGrid.from_arrays, else they are built here);
    'brute': exact O(Q * N) kNN, no grid (small meshes, testing)."""

    def __init__(self, mesh: TriangleMesh, device="cuda",
                 grid: Optional[CandidateGrid] = None,
                 cell_size: Optional[float] = None,
                 distance_method: str = "grid"):
        self.mesh = mesh
        if mesh.vertex_normals is None:
            mesh.compute_vertex_normals()
        dev = resolve_device(device)
        self.device = dev
        self.vertices = torch.as_tensor(
            np.asarray(mesh.vertices, np.float32), device=dev)
        self.vertex_normals = torch.as_tensor(
            np.asarray(mesh.vertex_normals, np.float32), device=dev)
        self.distance_method = distance_method
        if distance_method == "grid":
            if grid is None:
                grid = build_candidate_grid(mesh.vertices,
                                            cell_size=cell_size)
            self.grid = grid.to(dev)
        elif distance_method == "brute":
            self.grid = None
        else:
            raise NotImplementedError(distance_method)

    def to(self, device) -> "MeshGrid":
        """A copy whose tables (vertices, vertex normals, the candidate
        grid) are on `device`; the host mesh is shared."""
        dev = torch.device(device)
        out = copy.copy(self)
        out.device = dev
        out.vertices = self.vertices.to(dev, copy=True)
        out.vertex_normals = self.vertex_normals.to(dev, copy=True)
        if self.grid is not None:
            out.grid = self.grid.to(dev)
        return out

    def get_number_of_vertices(self) -> int:
        return int(self.vertices.shape[0])

    def knn(self, xyz: torch.Tensor, K: int = 8):
        """(..., 3) -> detached (sq_dist (..., K), indices (..., K))."""
        x = xyz.detach()
        if self.grid is not None:
            sq, idx = self.grid.query(x, k=K)
        else:
            shape = x.shape[:-1]
            sq, idx = knn_brute(x.reshape(-1, 3), self.vertices, K)
            sq = sq.reshape(shape + (K,))
            idx = idx.reshape(shape + (K,))
        return sq, idx

    def compute_distance(self, xyz: torch.Tensor, indicator_vector=None,
                         indicator_weight=0.1, K: int = 8):
        """Interpolated signed distance: (distance (..., 1), indices
        (..., K), weights (..., K)); indices and weights are detached, the
        distance is analytic in xyz and the indicator parameters."""
        sq, indices = self.knn(xyz, K)
        weights = interp.knn_weights(sq)
        ind_vec = (self.vertex_normals if indicator_vector is None
                   else indicator_vector)
        distance = interp.interpolated_distance(
            xyz, self.vertices, indices, weights, ind_vec, indicator_weight)
        return distance, indices, weights

    def cast_ray(self, rays_o, rays_d):
        """Nearest triangle hit of each (N, 3) ray through the host BVH:
        (t_hit (N,), primitive_ids (N,)) numpy, inf / -1 on a miss."""
        from .raycast import cast_rays
        return cast_rays(self.mesh, rays_o, rays_d)
