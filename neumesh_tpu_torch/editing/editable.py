"""Editing parameter containers (counterpart of
neumesh_tpu/editing/editable.py).

EditingParams: a per-vertex editing mask and an optional uv chart, with
the uv clamp and the aspect-preserving normalisation. EditablePrimitive:
a NeuMesh with its editing params and an edit_color_features tensor on
the model's device; update_mesh_grid swaps the mesh scaffold (and with it
the candidate grid) after a deformation.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def get_bbox(x: np.ndarray):
    return (np.array([x[..., 0].min(), x[..., 1].min()]),
            np.array([x[..., 0].max(), x[..., 1].max()]))


def normalize_uv(uv: np.ndarray, keep_wh: bool = False) -> np.ndarray:
    """In place: uv to [0, 1] per axis, or with keep_wh the longest side
    to [0, 1] and the aspect kept."""
    dmin, dmax = get_bbox(uv)
    if not keep_wh:
        uv[..., 0] = (uv[..., 0] - dmin[0]) / (dmax[0] - dmin[0])
        uv[..., 1] = (uv[..., 1] - dmin[1]) / (dmax[1] - dmin[1])
    else:
        step = max(dmax[0] - dmin[0], dmax[1] - dmin[1])
        uv[..., 0] = (uv[..., 0] - dmin[0]) / step
        uv[..., 1] = (uv[..., 1] - dmin[1]) / step
    return uv


class EditingParams:
    def __init__(self, editing_mask: np.ndarray,
                 uv: Optional[np.ndarray] = None,
                 vertex_ind_of_uv: Optional[np.ndarray] = None):
        self.editing_mask = np.asarray(editing_mask, bool)
        self.uv = uv
        self.vertex_ind_of_uv = vertex_ind_of_uv

    def clamp_params_in_uvdomain(self, min_value, max_value):
        """Keep the chart entries inside [min_value, max_value]; the mask
        becomes exactly their vertices."""
        uv = self.uv
        inside = ((uv[..., 0] >= min_value[0]) & (uv[..., 0] <= max_value[0])
                  & (uv[..., 1] >= min_value[1])
                  & (uv[..., 1] <= max_value[1]))
        self.uv = uv[inside]
        self.vertex_ind_of_uv = self.vertex_ind_of_uv[inside]
        self.editing_mask = self.editing_mask & False
        self.editing_mask[self.vertex_ind_of_uv] = True

    def get_size_of_uv(self):
        dmin, dmax = get_bbox(self.uv)
        return dmax - dmin

    def get_uv(self):
        return self.uv

    def get_vertex_ind_of_uv(self):
        return self.vertex_ind_of_uv

    def normalize_uv(self, keep_wh: bool = True):
        normalize_uv(self.uv, keep_wh)

    def clamp_and_normalize_params(self, min_value=(0.0, 0.0),
                                   max_value=(1.0, 1.0), keep_wh=True):
        self.clamp_params_in_uvdomain(min_value, max_value)
        self.normalize_uv(keep_wh)

    def get_editing_mask(self) -> np.ndarray:
        return self.editing_mask


class EditablePrimitive:
    """A NeuMesh, its editing params and its edit_color_features (N, F)
    f32 tensor on the model's device (zeros unless given)."""

    def __init__(self, model, editing_params_list: List[EditingParams],
                 color_feature_init=None):
        self.model = model
        self.editing_params_list = editing_params_list
        if color_feature_init is None:
            self.edit_color_features = torch.zeros_like(
                model.color_features, dtype=torch.float32).detach()
        else:
            self.edit_color_features = torch.as_tensor(
                np.asarray(color_feature_init, np.float32),
                device=model.device).clone()

    def get_len_of_mask(self) -> int:
        return len(self.editing_params_list)

    def get_editing_params(self, i: int = 0) -> EditingParams:
        return self.editing_params_list[i]

    def get_editing_masks(self) -> np.ndarray:
        return np.stack(
            [p.get_editing_mask() for p in self.editing_params_list], 0)

    def get_color_features(self) -> torch.Tensor:
        return self.edit_color_features

    def get_mesh(self):
        return self.model.mesh_grid.mesh

    def get_mesh_vertices(self) -> np.ndarray:
        return np.asarray(self.get_mesh().vertices)

    def update_mesh_grid(self, mesh):
        """Rebuild the scaffold after deforming it: a new MeshGrid (and
        candidate grid) on the model's device; the model's contexts read
        model.mesh_grid, so the swap is the whole rebuild."""
        from ..mesh.grid import MeshGrid
        old = self.model.mesh_grid
        self.model.mesh_grid = MeshGrid(
            mesh, device=self.model.device,
            distance_method=old.distance_method)
