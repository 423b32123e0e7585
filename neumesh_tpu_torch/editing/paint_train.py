"""Texture painting by fine-tuning (counterpart of
neumesh_tpu/editing/paint_train.py).

The geometry is frozen as the published paint.py freezes it: only
color_features requires a gradient and only it is in Adam; ln_s, the
geometry codes, the indicator vectors and weight and both MLPs stay as
loaded. The paintable vertices are those of the triangles the paint rays
hit (one cast of every paint ray); the gradient mask keeps the rows of
color_features of those vertices. Paint rays render with random colour
directions (view independence), background rays keep the teacher's
distillation. build_paint_step is the set-up that the CLI and the
benchmark's painting cell share.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..config import load_yaml, save_yaml
from ..dataio import get_data
from ..models import build_framework
from ..train.loop import build_train_step, to_device
from ..train.optimizers import get_optimizer
from ..utils.checkpoints import CheckpointIO
from ..utils.logger import Logger
from ..utils.print_fn import log
from ..utils.trace import spanned

SEED = 42


@spanned("paint.cast")
def get_optimized_features(mesh_grid, rays_o: np.ndarray,
                           rays_d: np.ndarray, batch_size=None):
    """Sorted unique vertex ids of the triangles the paint rays hit: one
    BVH build and one cast of every ray, or with batch_size one of each
    for every batch_size rays."""
    hit_vertices = []
    tris_all = np.asarray(mesh_grid.mesh.triangles)
    step = batch_size or max(len(rays_o), 1)
    for i in range(0, len(rays_o), step):
        t_hit, tri_ids = mesh_grid.cast_ray(rays_o[i:i + step],
                                            rays_d[i:i + step])
        miss = ~np.isfinite(t_hit)
        if miss.sum():
            log.warning(f"{int(miss.sum())} paint rays do not hit the mesh")
        hit_vertices.append(tris_all[tri_ids[~miss]].reshape(-1))
    if not hit_vertices:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(hit_vertices))


def make_grad_mask(model, optimized_indices: np.ndarray) -> dict:
    """{parameter name: mask}: a zero scalar for every parameter except
    color_features, whose (N, 1) mask is 1 on the painted rows (the
    masked form of a step that trains every parameter; build_paint_step
    freezes the rest and keeps only the color_features entry)."""
    mask = {name: torch.zeros((), device=p.device)
            for name, p in model.named_parameters()}
    vmask = torch.zeros((model.color_features.shape[0], 1),
                        device=model.device)
    vmask[torch.as_tensor(np.asarray(optimized_indices, np.int64),
                          device=model.device)] = 1.0
    mask["color_features"] = vmask
    return mask


def build_paint_step(args, trainer, render_kwargs_train, rays_o_paint,
                     rays_d_paint):
    """The painting fine-tune's set-up: the paintable vertices from one
    cast of the paint rays (numpy (N, 3)), Adam over color_features alone
    (args.training's lr and schedule) and build_train_step's painting
    step, whose gradient mask keeps the painted rows of color_features.
    The step turns off the gradients of every other parameter of the
    student. -> (train_step, optimizer, optimized_indices)."""
    model = trainer.model
    optimized_indices = get_optimized_features(model.mesh_grid, rays_o_paint,
                                               rays_d_paint)
    mask = make_grad_mask(model, optimized_indices)
    opt = get_optimizer(args, model, names=("color_features",))
    train_step = build_train_step(
        trainer, opt, render_kwargs_train, 0, 0, 0,
        matmul_precision=args.training.get("matmul_precision", "default"),
        painting=True, grad_mask={"color_features": mask["color_features"]})
    return train_step, opt, optimized_indices


def update_paint_config(paint_config: dict, cli_args=None):
    """The main training config with the paint JSON laid over it."""
    main_config = load_yaml(paint_config["main_config"])
    main_config.expname = (main_config.expname + "_"
                           + paint_config["paint_name"])
    main_config.data.split = "entire"
    main_config.data.data_dir = paint_config["paint_dir"]
    main_config.data.batch_size = paint_config.get("batch_size", 512)
    main_config.data.setdefault("paint_dataset", True)
    main_config.training.exp_dir = os.path.join(
        main_config.training.log_root_dir, main_config.expname)
    main_config.training.ckpt_file = paint_config["ckpt_path"]
    main_config.training.num_iters = paint_config["num_iters"]
    main_config.training.i_val = paint_config.get("i_val", 1000)
    main_config.training.lr = paint_config.get("lr", 1e-2)
    main_config.training.loss_weights["distill_density"] = 1.0
    main_config.training.loss_weights["distill_color"] = 1.0
    main_config.training.loss_weights["indicator_reg"] = 1.0
    main_config.training.loss_weights["img"] = 1.0
    main_config.training.loss_weights["mask"] = 0.0
    for k, v in paint_config.items():
        main_config[k] = v
    if cli_args is not None:
        for k, v in vars(cli_args).items():
            if k != "config":
                main_config[k] = v
    return main_config


def main_function(args):
    """Fine-tune the painted vertices' colour codes on args.device (the
    card by default). Returns {"model", "optimized_indices",
    "it", "losses" (per step: {name: float}), "step_s" (host seconds per
    step, each ending in a device synchronize), "raycast_s" (host seconds
    of build_paint_step, nearly all of it the ray cast), "ckpt"}."""
    device = resolve_device(args.get("device", None) or "cuda")
    exp_dir = args.training.exp_dir
    logger = Logger(log_dir=exp_dir,
                    monitoring=args.training.get("monitoring", "none"))
    os.makedirs(exp_dir, exist_ok=True)
    save_yaml(args, os.path.join(exp_dir, "config.yaml"))

    dataset = get_data(args)           # PaintDataset (paint_dataset=True)
    model, trainer, render_kwargs_train, _, _ = build_framework(
        args, args.model.framework, device=device, seed=SEED)
    if trainer.teacher_model is None:
        raise ValueError("painting requires the teacher (distillation on the "
                         "background rays): set training.teacher_config / "
                         "teacher_ckpt")

    ckpt_io = CheckpointIO(os.path.join(exp_dir, "ckpts"))
    ckpt_file = args.training.ckpt_file
    log.info(f"=> Loading main ckpt {ckpt_file}")
    ckpt_io.load_file(str(ckpt_file), model)

    log.info("=> Finding paintable vertices (ray casting)")
    t0 = time.perf_counter()
    train_step, opt, optimized_indices = build_paint_step(
        args, trainer, render_kwargs_train, dataset.rays_o_paint,
        dataset.rays_d_paint)
    raycast_s = time.perf_counter() - t0
    log.info(f"=> {len(optimized_indices)} paintable vertices "
             f"({raycast_s:.2f} s)")

    num_iters = args.training.num_iters
    data_rng = np.random.default_rng(0)
    generator = torch.Generator(device=device).manual_seed(SEED)
    it, losses, step_s = 0, [], []
    t_start = time.time()
    while it < num_iters:
        for _, model_input, ground_truth in dataset.epoch_batches(
                args.data.batch_size, data_rng):
            if it >= num_iters:
                break
            t0 = time.perf_counter()
            total, scalars = train_step(to_device(model_input, device),
                                        to_device(ground_truth, device),
                                        generator)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - t0)
            losses.append({k: float(v) for k, v in scalars.items()})
            it += 1
            if it % args.training.get("i_log", 20) == 0:
                log.info(f"it {it}/{num_iters} loss {float(total):.4f} "
                         f"psnr {float(scalars['psnr']):.2f}")
                for k, v in scalars.items():
                    logger.add("losses", k, float(v), it)

    ckpt = ckpt_io.save(f"final_{it:08d}.ckpt", model=model,
                        optimizer=opt.state_dict(), global_step=it,
                        epoch_idx=0)
    logger.flush()
    log.info(f"=> Painting done in {time.time() - t_start:.1f}s")
    return {"model": model, "optimized_indices": optimized_indices,
            "it": it, "losses": losses, "step_s": step_s,
            "raycast_s": raycast_s, "ckpt": ckpt}
