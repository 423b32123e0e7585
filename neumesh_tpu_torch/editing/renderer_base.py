"""The TextureEditableRenderer template (counterpart of
neumesh_tpu/editing/renderer_base.py): load the main model and N
reference models with their checkpoints and editing masks, let the
subclass transfer colour codes, wrap everything in a
TextureEditableNeuMesh and render it through the render CLI's
render_function, which calls the frame entry of args.render_mode.
"""
from __future__ import annotations

import abc
import time

from .. import resolve_device
from ..config import ConfigDict, load_yaml
from ..utils.print_fn import log
from .editable import EditablePrimitive
from .texture_model import TextureEditableNeuMesh


def load_neumesh_from_config(config_path: str, ckpt_file: str,
                             device="cuda"):
    """(model, config, render_kwargs_test): the NeuMesh of a training
    config on `device` with a checkpoint loaded (either `.ckpt` kind or a
    reference-format `.pt`). The distillation teacher is not built."""
    from ..models import build_framework
    from ..utils.checkpoints import CheckpointIO

    main_args = load_yaml(config_path)
    cfg = ConfigDict(main_args.to_dict())
    cfg.training.pop("teacher_config", None)
    cfg.training.pop("teacher_ckpt", None)
    model, _, _, render_kwargs_test, _ = build_framework(
        cfg, "NeuMesh", device=resolve_device(device))
    CheckpointIO().load_file(str(ckpt_file), model)
    model.requires_grad_(False)
    return model, main_args, render_kwargs_test


class TextureEditableRenderer(abc.ABC):
    """After forward: stats holds host seconds of the edit's steps
    (load_s, transfer_s, knn_s, align_s or arap_s, meshgrid_s), T_r_m the
    transforms of the transfer (None for filling)."""

    def __init__(self):
        self.stats = {}
        self.T_r_m = None

    def _add(self, key, seconds):
        self.stats[key] = self.stats.get(key, 0.0) + seconds

    def forward(self, args):
        """Edit and render; returns (the editable model, render_function's
        dict)."""
        from ..cli import render as render_cli

        device = args.get("device", None) or "cuda"
        t0 = time.perf_counter()
        main_primitive, main_args, render_kwargs_test = self.read_data(
            args.main_config, args.main_mask_mesh, args.main_ckpt, device)
        ref_primitives = []
        for i in range(len(args.ref_config)):
            ref_primitive, _, _ = self.read_data(
                args.ref_config[i], [args.ref_mask_mesh[i]],
                args.ref_ckpt[i], device)
            ref_primitives.append(ref_primitive)
        self._add("load_s", time.perf_counter() - t0)
        assert main_primitive.get_len_of_mask() == len(ref_primitives), (
            "number of main masks does not match number of ref objects")

        t0 = time.perf_counter()
        T_r_m_list = self.transfer_texture_features(
            args, main_primitive, ref_primitives)
        self._add("transfer_s", time.perf_counter() - t0)
        self.T_r_m = T_r_m_list

        log.info("[Info] create TextureEditableNeuMesh")
        model = TextureEditableNeuMesh(
            main_primitive.model, [rp.model for rp in ref_primitives],
            main_primitive.get_editing_masks(), T_r_m_list,
            [main_primitive.edit_color_features] * len(ref_primitives))

        for k, v in dict(main_args).items():
            if k not in args:
                args[k] = v
        # either frame entry: the editable exposes bind_rays_tiled,
        # fused_secant and fused_locate
        out = render_cli.render_function(args, model, render_kwargs_test)
        return model, out

    def read_data(self, config_path, mask_paths, ckpt_file, device="cuda"):
        model, main_args, render_kwargs_test = load_neumesh_from_config(
            config_path, ckpt_file, device)
        editing_params_list = [
            self.read_editing_mask(p, model.mesh_grid.mesh)
            for p in mask_paths]
        return (EditablePrimitive(model, editing_params_list), main_args,
                render_kwargs_test)

    @abc.abstractmethod
    def read_editing_mask(self, mask_path, mesh):
        raise NotImplementedError

    @abc.abstractmethod
    def transfer_texture_features(self, args, main_primitive,
                                  ref_primitives):
        raise NotImplementedError
