"""Texture filling (counterpart of neumesh_tpu/editing/fill.py): tile a
reference uv pattern over the main mesh's uv chart and transfer colour
codes by a Kc-NN search in uv space (the host library's KD-tree,
cpp/native.py, on the uv points at z = 0)."""
from __future__ import annotations

import time

import numpy as np

from ..cpp import native
from ..mesh.triangle_mesh import load_mesh
from ..utils.print_fn import log
from .editable import EditingParams
from .renderer_base import TextureEditableRenderer
from .swap import write_transfer


def _knn(query, points, k):
    """kNN in the uv plane: the 3-D KD-tree over (u, v, 0)."""
    q3 = np.concatenate([query, np.zeros((len(query), 1))], -1)
    p3 = np.concatenate([points, np.zeros((len(points), 1))], -1)
    return native.KDTree(p3).query(q3, k=k)


def _exact_nn(v1: np.ndarray, v2: np.ndarray, EPS=1e-6):
    """The nearest vertex of v2 for each vertex of v1; asserts that the
    two meshes are aligned."""
    d, nbr = native.KDTree(v2).query(v1, k=1)
    d, nbr = d[:, 0], nbr[:, 0]
    assert np.all(d < EPS), (
        f"[Error] Misalignment between meshes (max {d.max()}, mean "
        f"{d.mean()}): the mask mesh must match the model mesh")
    return nbr


class TextureFillingRender(TextureEditableRenderer):
    def read_editing_mask(self, mask_path, mesh):
        """Mask = the model vertices whose coincident mask-mesh vertex has
        a nonzero uv (the PLY's per-vertex s/t); the chart collects (uv,
        model vertex)."""
        mask_mesh = load_mesh(mask_path)
        if mask_mesh.vertex_uvs is None:
            raise ValueError(f"{mask_path}: mask mesh has no per-vertex uv "
                             "(s/t) properties")
        model_v = np.asarray(mesh.vertices, np.float64)
        mask_v = np.asarray(mask_mesh.vertices, np.float64)
        neighbors_in_maskmesh = _exact_nn(model_v, mask_v)
        uvs = np.asarray(mask_mesh.vertex_uvs, np.float64)
        has_uv = np.linalg.norm(uvs, axis=-1) > 1e-8
        mask = has_uv[neighbors_in_maskmesh]
        model_idx = np.where(mask)[0]
        model_uv = uvs[neighbors_in_maskmesh[model_idx]]
        return EditingParams(mask, model_uv.copy(), model_idx)

    def transfer_texture_features(self, args, main_primitive,
                                  ref_primitives):
        steps = args.get("step", [1] * len(ref_primitives))
        for i, ref_primitive in enumerate(ref_primitives):
            main_editing_params = main_primitive.get_editing_params(i)
            ref_editing_params = ref_primitive.get_editing_params(0)
            main_editing_params.clamp_and_normalize_params()
            ref_editing_params.clamp_and_normalize_params()
            self.transfer(main_primitive, main_editing_params,
                          ref_primitive, ref_editing_params,
                          steps=steps[i], Kc=args.get("Kc", 4))
        return None  # no rigid transform for uv filling

    def transfer(self, main_primitive, main_params, ref_primitive,
                 ref_params, steps=1, Kc=4):
        t0 = time.perf_counter()
        weights, ref_feat_indices, main_feat_indices = \
            self.compute_transition_weights(main_params, ref_params, steps,
                                            Kc)
        self._add("knn_s", time.perf_counter() - t0)
        write_transfer(main_primitive, ref_primitive, weights,
                       ref_feat_indices, main_feat_indices)
        log.info(f"[fill] transferred {len(main_feat_indices)} vertex codes")

    @staticmethod
    def compute_transition_weights(main_params, ref_params, steps, Kc):
        """Tile the reference uv pattern `steps` times across the main uv
        domain's longest reference axis."""
        mainuv_size = main_params.get_size_of_uv()
        refuv_size = ref_params.get_size_of_uv()
        dimension = int(np.argmax(refuv_size))
        ref_scale = mainuv_size[dimension] / (steps * refuv_size[dimension])
        kernel_size = refuv_size * ref_scale
        coord = main_params.get_uv() / kernel_size
        coord_in_kernel = ((coord - np.int32(coord)) * kernel_size) \
            / ref_scale
        distance, nbr = _knn(coord_in_kernel,
                             ref_params.get_uv().reshape(-1, 2), Kc)
        w = 1.0 / (distance + 1e-8)
        w = w / np.sum(w, axis=-1, keepdims=True)
        return (w.astype(np.float32),
                ref_params.get_vertex_ind_of_uv()[nbr],
                main_params.get_vertex_ind_of_uv())
