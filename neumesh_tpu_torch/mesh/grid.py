"""MeshGrid: the mesh scaffold as tensors on the model's device
(counterpart of neumesh_tpu/mesh/grid.py)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops.knn import CandidateGrid, build_candidate_grid
from .triangle_mesh import TriangleMesh


class MeshGrid:
    """Vertices, vertex normals and candidate-grid tables on `device`.
    `grid` adopts tables built elsewhere (CandidateGrid.from_arrays), else
    they are built here."""

    def __init__(self, mesh: TriangleMesh, device="cuda",
                 grid: Optional[CandidateGrid] = None,
                 cell_size: Optional[float] = None):
        self.mesh = mesh
        if mesh.vertex_normals is None:
            mesh.compute_vertex_normals()
        dev = resolve_device(device)
        self.device = dev
        self.vertices = torch.as_tensor(
            np.asarray(mesh.vertices, np.float32), device=dev)
        self.vertex_normals = torch.as_tensor(
            np.asarray(mesh.vertex_normals, np.float32), device=dev)
        if grid is None:
            grid = build_candidate_grid(mesh.vertices, cell_size=cell_size)
        self.grid = grid.to(dev)

    def get_number_of_vertices(self) -> int:
        return int(self.vertices.shape[0])
