"""Headless mesh-editing previews (counterpart of
neumesh_tpu/utils/vis_mesh.py).

The reference pops Open3D windows to inspect editing masks and feature
transfers (vis_and_painting / preview_transfer_on_mesh); these write
colour-coded PLYs instead, to open in any viewer.
"""
from __future__ import annotations

import numpy as np

from ..mesh.triangle_mesh import TriangleMesh, save_ply
from .print_fn import log


def vis_and_painting(mesh: TriangleMesh, painting_mask: np.ndarray,
                     out_path: str = "editing_mask_preview.ply"):
    """Masked vertices red, others grey."""
    preview = TriangleMesh(mesh.vertices.copy(), mesh.triangles.copy())
    colors = np.full((mesh.n_vertices, 3), 0.6)
    colors[np.asarray(painting_mask, bool)] = [1.0, 0.1, 0.1]
    preview.vertex_colors = colors
    save_ply(preview, out_path)
    log.info(f"[vis] wrote editing-mask preview: {out_path}")
    return out_path


def preview_transfer_on_mesh(main_mesh: TriangleMesh, ref_mesh: TriangleMesh,
                             ref_feat_indices: np.ndarray,
                             weights: np.ndarray,
                             main_feat_indices: np.ndarray,
                             out_prefix: str = "transfer_preview"):
    """Visualise a feature transfer: the main mesh colored by which ref
    vertex dominates each transferred code (hashed to color), the ref mesh
    with source vertices highlighted."""
    main_prev = TriangleMesh(main_mesh.vertices.copy(),
                             main_mesh.triangles.copy())
    colors = np.full((main_mesh.n_vertices, 3), 0.6)
    dominant = np.asarray(ref_feat_indices)[
        np.arange(len(main_feat_indices)), np.argmax(weights, axis=-1)]
    hashed = (dominant[:, None] * np.array([[0.137, 0.491, 0.733]])) % 1.0
    colors[main_feat_indices] = 0.2 + 0.8 * hashed
    main_prev.vertex_colors = colors
    p1 = f"{out_prefix}_main.ply"
    save_ply(main_prev, p1)

    ref_prev = TriangleMesh(ref_mesh.vertices.copy(),
                            ref_mesh.triangles.copy())
    rcolors = np.full((ref_mesh.n_vertices, 3), 0.6)
    rcolors[np.unique(np.asarray(ref_feat_indices).reshape(-1))] = \
        [0.1, 0.8, 0.2]
    ref_prev.vertex_colors = rcolors
    p2 = f"{out_prefix}_ref.ply"
    save_ply(ref_prev, p2)
    log.info(f"[vis] wrote transfer previews: {p1}, {p2}")
    return p1, p2
