"""NeuMesh framework builder (counterpart of
neumesh_tpu/models/neumesh/__init__.py): every model-config key the JAX
builder reads, with its defaults written back into the config, except the
TPU's program blocking (pallas_sample_block, *_tiles_per_program), which
has no counterpart here."""
from __future__ import annotations

import copy

import torch

from ...mesh.grid import MeshGrid
from ...mesh.triangle_mesh import load_mesh
from .model import NeuMesh


def get_model(args, device="cuda", seed: int = 42):
    from ...render.volume import SingleRenderer

    model_args = args["model"]
    if (args.training.get("teacher_ckpt") is not None
            and args.training.get("teacher_config") is not None):
        raise NotImplementedError(
            "training.teacher_config / teacher_ckpt: the NeuS teacher waits "
            "for the training slice of the port; set both to null to render")

    mesh = load_mesh(model_args.prior_mesh)
    mesh_grid = MeshGrid(
        mesh, device=device,
        distance_method=model_args.setdefault("distance_method", "grid"))

    model_config = {
        "speed_factor": args.training.setdefault("speed_factor", 1.0),
        "D_density": model_args.setdefault("D_density", 3),
        "D_color": model_args.setdefault("D_color", 4),
        "W": model_args.setdefault("W", 256),
        "geometry_dim": model_args.get("geometry_dim", 32),
        "color_dim": model_args.setdefault("color_dim", 32),
        "multires_view": model_args.setdefault("multires_view", 4),
        "multires_d": model_args.setdefault("multires_d", 8),
        "multires_fg": model_args.setdefault("multires_fg", 2),
        "multires_ft": model_args.setdefault("multires_ft", 2),
        "enable_nablas_input": model_args.setdefault(
            "enable_nablas_input", False),
        "learn_indicator_weight": model_args.get(
            "learn_indicator_weight", False),
        "max_candidates": model_args.get("max_candidates", 96),
        "use_pallas": model_args.get("use_pallas", False),
        "f32_layers": tuple(model_args.get("f32_layers", ())),
        "scan_candidates": model_args.get("scan_candidates", 0),
        "tile_kp_per_probe": model_args.get("tile_kp_per_probe", 0),
        "scan_knn_k": model_args.get("scan_knn_k", 0),
        "secant_full_precision": model_args.get(
            "secant_full_precision", True),
        "tile_cell_budget": model_args.get("tile_cell_budget", 0),
        "secant_rebracket": model_args.get("secant_rebracket", True),
        "secant_frozen_knn": model_args.get("secant_frozen_knn", False),
        "eval_candidates": model_args.get("eval_candidates", 0),
    }
    cdt = model_args.get("compute_dtype", None)
    if cdt in ("bfloat16", "bf16"):
        model_config["compute_dtype"] = torch.bfloat16
    elif cdt not in (None, "None", "float32", "f32"):
        raise ValueError(
            f"model.compute_dtype must be bfloat16/bf16 or float32/f32, "
            f"got {cdt!r}")

    render_kwargs_train = {
        "N_nograd_samples": args.model.setdefault("N_nograd_samples", 2048),
        "N_samples": args.model.setdefault("N_samples", 64),
        "N_importance": args.model.setdefault("N_importance", 64),
        "N_upsample_iters": args.model.setdefault("N_upsample_iters", 4),
        "obj_bounding_radius": args.data.setdefault("obj_bounding_radius",
                                                    1.0),
        "batched": args.data.get("batch_size") is not None,
        "perturb": args.model.setdefault("perturb", True),
        "white_bkgd": args.model.setdefault("white_bkgd", False),
        "bounded_near_far": model_args.setdefault("bounded_near_far", True),
    }
    loss_weights = args.training.get("loss_weights", {}) or {}
    if loss_weights.get("eikonal", 0.0) > 0:
        render_kwargs_train["calc_normal"] = True

    render_kwargs_test = copy.deepcopy(render_kwargs_train)
    render_kwargs_test["rayschunk"] = args.data.setdefault(
        "val_rayschunk", 4096)
    render_kwargs_test["perturb"] = False

    model = NeuMesh(mesh_grid, device=device, **model_config).init(seed)
    return (model, None, render_kwargs_train, render_kwargs_test,
            SingleRenderer(model))
