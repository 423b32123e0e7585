"""NeuMesh framework builder (counterpart of
neumesh_tpu/models/neumesh/__init__.py): every model-config key the JAX
builder reads, with its defaults written back into the config, except the
TPU's program blocking (pallas_sample_block, *_tiles_per_program), which
has no counterpart here. With training.teacher_config / teacher_ckpt set,
the frozen NeuS teacher is built and loaded, and the student starts from
a copy of its ln_s and takes its speed_factor."""
from __future__ import annotations

import copy

import torch

from ...config import load_yaml
from ...mesh.grid import MeshGrid
from ...mesh.triangle_mesh import load_mesh
from ..neus import loss_weights_of
from .model import NeuMesh


def load_teacher(teacher_config_path: str, teacher_ckpt_path: str,
                 device="cuda"):
    """The frozen teacher from its config and checkpoint (a torch zip in
    the reference layout, or the JAX package's native msgpack `.ckpt`):
    every parameter without gradient."""
    from .. import build_framework
    from ...utils.checkpoints import CheckpointIO

    teacher_config = load_yaml(teacher_config_path)
    teacher, *_ = build_framework(teacher_config,
                                  teacher_config.model.framework,
                                  device=device, seed=0)
    CheckpointIO().load_file(teacher_ckpt_path, teacher)
    teacher.requires_grad_(False)
    return teacher


def get_model(args, device="cuda", seed: int = 42):
    from ...render.volume import SingleRenderer
    from ...train.trainer import Trainer

    model_args = args["model"]
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
    loss_weights = loss_weights_of(args, indicator_reg=0.1)
    if loss_weights["eikonal"] > 0:
        render_kwargs_train["calc_normal"] = True

    render_kwargs_test = copy.deepcopy(render_kwargs_train)
    render_kwargs_test["rayschunk"] = args.data.setdefault(
        "val_rayschunk", 4096)
    render_kwargs_test["perturb"] = False

    model = NeuMesh(mesh_grid, device=device, **model_config).init(seed)

    teacher = None
    if (args.training.get("teacher_ckpt") is not None
            and args.training.get("teacher_config") is not None):
        teacher = load_teacher(args.training.teacher_config,
                               args.training.teacher_ckpt, device=device)
        # the student starts from a COPY of the teacher's CDF sharpness:
        # its own parameter, trained apart from the frozen teacher's
        with torch.no_grad():
            model.ln_s.copy_(teacher.ln_s.detach().clone())
        model.speed_factor = teacher.speed_factor

    # distill_density_clip: None is the plain L1 mean the reference ships;
    # a float opts into the masked variant
    trainer = Trainer(
        model, loss_weights, teacher_model=teacher,
        distill_density_clip=args.training.setdefault(
            "distill_density_clip", None),
        teacher_dtype=args.training.get("teacher_dtype", None))
    return (model, trainer, render_kwargs_train, render_kwargs_test,
            SingleRenderer(model))
