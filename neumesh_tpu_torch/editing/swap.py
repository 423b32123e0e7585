"""Texture swapping (counterpart of neumesh_tpu/editing/swap.py).

The editing mask is the set of vertices with a non-black colour in a mask
mesh; the alignment comes from correspondences in the config (Umeyama +
ICP, align.py) or a given T_r_m; optionally the reference mesh is warped
onto the main one by ARAP (mesh/arap.py). The transfer maps the main
masked vertices by T_r_m, finds their Kc nearest reference masked
vertices (the host library's KD-tree, cpp/native.py) and writes the
inverse-distance weighted average of the reference colour codes into
edit_color_features (span edit.transfer).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..cpp import native
from ..mesh.arap import arap
from ..mesh.triangle_mesh import TriangleMesh, load_mesh
from ..utils.print_fn import log
from ..utils.trace import spanned
from .align import estimate_transform_from_corr
from .editable import EditingParams
from .renderer_base import TextureEditableRenderer


def knn(query, points, k):
    """(distance (Q, k), index (Q, k)) of each query's k nearest points."""
    return native.KDTree(points).query(query, k=k)


def deform_ref_mesh_arap(main_pts_in_ref, corr_ref_ids,
                         ref_mesh: TriangleMesh, ref_mask,
                         max_iter: int = 20):
    """ARAP-warp the reference mesh (in place) so its correspondence
    vertices land on the transformed main correspondences; unedited and
    isolated vertices stay fixed."""
    ref_mesh.remove_duplicated_triangles()
    isolated = ref_mesh.isolated_vertex_mask()
    static_ids = np.where(~ref_mask | isolated)[0]
    handle_ids = np.asarray(corr_ref_ids, np.int64)
    cids = np.concatenate([static_ids, handle_ids])
    cpos = np.concatenate([ref_mesh.vertices[static_ids], main_pts_in_ref])
    ref_mesh.vertices = arap(ref_mesh.vertices, ref_mesh.triangles, cids,
                             cpos, max_iter=max_iter)
    ref_mesh.compute_vertex_normals()
    return ref_mesh


def align_mesh(main_mesh, main_editing_mask, ref_mesh, ref_editing_mask,
               T_r_m=None, corr=None, use_arap=False):
    """(T_r_m, corr, the possibly deformed reference mesh)."""
    if corr is None:
        raise ValueError("no correspondences: provide `corr` (and optionally "
                         "`T_r_m`) in the editing config")
    corr = np.asarray(corr, np.int64)
    if T_r_m is None:
        T_r_m = estimate_transform_from_corr(
            np.asarray(main_mesh.vertices), np.asarray(ref_mesh.vertices),
            corr)
    else:
        T_r_m = np.asarray(T_r_m, np.float64)
    if use_arap:
        pt1 = np.asarray(main_mesh.vertices)[corr[:, 0]]
        pt1_trans = pt1 @ T_r_m[:3, :3].T + T_r_m[:3, 3]
        ref_mesh = deform_ref_mesh_arap(pt1_trans, corr[:, 1], ref_mesh,
                                        ref_editing_mask)
    return T_r_m, corr, ref_mesh


class TextureSwappingRender(TextureEditableRenderer):
    def read_editing_mask(self, mask_path, mesh):
        mask_mesh = load_mesh(mask_path)
        if mask_mesh.vertex_colors is None:
            raise ValueError(f"{mask_path}: mask mesh has no vertex colors")
        mask = np.sum(np.asarray(mask_mesh.vertex_colors), axis=-1) != 0
        return EditingParams(mask)

    def transfer_texture_features(self, args, main_primitive,
                                  ref_primitives):
        T_r_m_list = []
        use_arap = args.get("use_arap", False)
        for i, ref_primitive in enumerate(ref_primitives):
            main_editing_params = main_primitive.get_editing_params(i)
            ref_editing_params = ref_primitive.get_editing_params(0)
            cfg_T = args.get("T_r_m", None) or []
            cfg_corr = args.get("corr", None) or []
            t0 = time.perf_counter()
            T_r_m, corr, ref_mesh_deformed = align_mesh(
                main_primitive.get_mesh(),
                main_editing_params.get_editing_mask(),
                ref_primitive.get_mesh(),
                ref_editing_params.get_editing_mask(),
                T_r_m=cfg_T[i] if len(cfg_T) > i else None,
                corr=cfg_corr[i] if len(cfg_corr) > i else None,
                use_arap=use_arap)
            self._add("arap_s" if use_arap else "align_s",
                      time.perf_counter() - t0)
            if use_arap:
                t0 = time.perf_counter()
                ref_primitive.update_mesh_grid(ref_mesh_deformed)
                self._add("meshgrid_s", time.perf_counter() - t0)
            self.transfer(main_primitive, main_editing_params,
                          ref_primitive, ref_editing_params,
                          np.asarray(T_r_m), Kc=args.get("Kc", 4))
            T_r_m_list.append(np.asarray(T_r_m))
        return np.stack(T_r_m_list)

    @spanned("edit.transfer")
    def transfer(self, main_primitive, main_params, ref_primitive,
                 ref_params, T_r_m, Kc: int = 4):
        t0 = time.perf_counter()
        weights, ref_feat_indices, main_feat_indices = \
            self.compute_transition_weights(
                main_primitive.get_mesh_vertices(), main_params,
                ref_primitive.get_mesh_vertices(), ref_params, T_r_m, Kc)
        self._add("knn_s", time.perf_counter() - t0)
        write_transfer(main_primitive, ref_primitive, weights,
                       ref_feat_indices, main_feat_indices)
        log.info(f"[swap] transferred {len(main_feat_indices)} vertex codes")

    @staticmethod
    def compute_transition_weights(main_vertices, main_params, ref_vertices,
                                   ref_params, T_r_m, Kc):
        """(weights (n, Kc) f32, reference vertex ids (n, Kc), main vertex
        ids (n,)) of the main masked vertices."""
        main_mask = main_params.get_editing_mask()
        ref_mask = ref_params.get_editing_mask()
        main_idx = np.where(main_mask)[0]
        ref_idx = np.where(ref_mask)[0]
        main_pts = main_vertices[main_mask]
        ref_pts = ref_vertices[ref_mask]
        main_trans = main_pts @ T_r_m[:3, :3].T + T_r_m[:3, 3]
        distance, nbr = knn(main_trans, ref_pts.reshape(-1, 3), Kc)
        w = 1.0 / (distance + 1e-8)
        w = w / np.sum(w, axis=-1, keepdims=True)
        return w.astype(np.float32), ref_idx[nbr], main_idx


def write_transfer(main_primitive, ref_primitive, weights, ref_feat_indices,
                   main_feat_indices):
    """edit_color_features[main ids] = sum_k w_k ref color_features[ref
    ids_k], summed on the host in f32 as the JAX package sums it."""
    ref_feat = ref_primitive.model.color_features.detach().cpu().numpy()
    new = np.sum(weights[..., None] * ref_feat[ref_feat_indices], axis=-2)
    ef = main_primitive.edit_color_features
    ef[torch.as_tensor(main_feat_indices, device=ef.device)] = \
        torch.as_tensor(new, device=ef.device)
