"""Geometry editing (counterpart of neumesh_tpu/editing/geometry.py): swap
the mesh scaffold for a deformed one with the same vertices (made
offline, e.g. in Blender) and rotate each vertex's indicator vector by the
rotation that takes its old normal to its new one. The feature codes are
untouched."""
from __future__ import annotations

import numpy as np
import torch

from ..mesh.grid import MeshGrid
from ..mesh.triangle_mesh import TriangleMesh


def rodrigues(axis_angle: np.ndarray) -> np.ndarray:
    """(N, 3) axis-angle -> (N, 3, 3) rotation matrices; the zero vector
    maps to the identity."""
    theta = np.linalg.norm(axis_angle, axis=-1, keepdims=True)  # (N, 1)
    small = theta[:, 0] < 1e-12
    axis = axis_angle / np.where(theta < 1e-12, 1.0, theta)
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    K = np.zeros((len(axis), 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -z, y
    K[:, 1, 0], K[:, 1, 2] = z, -x
    K[:, 2, 0], K[:, 2, 1] = -y, x
    c = np.cos(theta)[..., None]
    s = np.sin(theta)[..., None]
    eye = np.broadcast_to(np.eye(3), (len(axis), 3, 3))
    R = c * eye + s * K + (1 - c) * np.einsum("ni,nj->nij", axis, axis)
    R[small] = np.eye(3)
    return R


def deform_model(deformed_mesh: TriangleMesh, model,
                 fix_indicator: bool = False):
    """Replace model.mesh_grid by a MeshGrid (and candidate grid) of the
    deformed mesh on the model's device; unless fix_indicator, rotate the
    indicator vectors by the old -> new normal rotation in float64 on the
    host (a 180-degree turn flips them) and write them back in f32.
    Returns the model."""
    new_grid = MeshGrid(deformed_mesh, device=model.device,
                        distance_method=model.mesh_grid.distance_method)
    if not fix_indicator:
        n_old = model.mesh_grid.vertex_normals.cpu().numpy().astype(
            np.float64)
        n_new = new_grid.vertex_normals.cpu().numpy().astype(np.float64)
        assert len(n_old) == len(n_new), (
            "deformed mesh must keep the vertex count/order")
        rot_axis = np.cross(n_old, n_new)
        cos_theta = np.clip(
            np.sum(n_old * n_new, -1)
            / (np.linalg.norm(n_old, axis=-1)
               * np.linalg.norm(n_new, axis=-1)), -1.0, 1.0)
        rot_180 = cos_theta == -1
        R = rodrigues(rot_axis * np.arccos(cos_theta)[:, None])
        ind = model.indicator_vector.detach().cpu().numpy().astype(
            np.float64)
        new_ind = np.einsum("nij,nj->ni", R, ind)
        new_ind[rot_180] *= -1
        with torch.no_grad():
            model.indicator_vector.copy_(torch.as_tensor(
                new_ind.astype(np.float32), device=model.device))
    model.mesh_grid = new_grid
    return model
