"""Training loop (counterpart of neumesh_tpu/train/loop.py).

A train step samples rays, renders them, computes every loss, runs
backward, takes the global gradient norm and steps Adam. Around it:
periodic full-image validation (i_val), time-based latest checkpoints
(i_save seconds), step-based backups (i_backup), an interrupt-safe save,
resume from latest.ckpt with the optimizer state, and the ms/it and
rays/s log line (i_log). training.debug_nans turns on autograd's anomaly
detection with its NaN check and raises on a non-finite loss;
training.profile_dir writes a torch.profiler Chrome trace of the run
(rank 0).

Data parallel (one process per GPU under torchrun or SLURM,
parallel/dist.py): the ranks form a (batch x data) grid
(parallel/mesh.py). Each update takes batch_size images per host from a
shared epoch order, each rank of a host a slice of their rays; random
draws keep the global shape, masked losses divide by the group's counts,
and the gradients are all-reduced before the grad norm and the Adam step,
so an update equals the single-process update on the concatenated batch.
`it` advances by the batch axis's size (the hosts), which also scales the
schedule and divides i_val and i_backup. Only rank 0 writes the config,
checkpoints and validation images; every rank makes the rng draws.
training.use_device_mesh false puts every rank on the batch axis.

Precision: matmul_precision "highest" keeps exact f32 matmuls; any other
value (the default "default") lets cuBLAS use TF32 on the card, as the
JAX package trains below exact f32; on the CPU training stays exact f32.
The up-sampling density kernel (field_fused, no gradient) stays exact
f32 either way.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..config import backup_sources, save_yaml
from ..dataio import get_data
from ..models import build_framework
from ..parallel import (ShardedGenerator, all_reduce_grads, broadcast_params,
                        dist, get_global_mesh, global_sum,
                        make_global_batch)
from ..utils.checkpoints import CheckpointIO
from ..utils.logger import Logger
from ..utils.print_fn import log
from ..utils.trace import count, count_device, enabled, span, spanned
from .optimizers import current_lr, get_optimizer
from .pretrain import maybe_pretrain_siren

SEED = 42


def _set_matmul_precision(precision: str, device) -> None:
    """TF32 for the card's matmuls unless precision is "highest". On the
    CPU nothing is set: the flags are process-wide (allow_tf32 also moves
    torch's float32 matmul precision, which the CPU backends read), and
    CPU training stays exact f32."""
    if torch.device(device).type != "cuda":
        return
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def build_train_step(trainer, opt, render_kwargs_train, N_rays, H, W,
                     matmul_precision: str = "default",
                     painting: bool = False, grad_mask=None,
                     debug_nans: bool = False):
    """train_step(model_input, ground_truth, generator, select_inds=None)
    -> (total loss, scalars), both detached: zero_grad -> loss ->
    backward -> gradient mask -> (under a process group: the gradients
    all-reduced, the logged losses averaged over the ranks) -> global grad
    norm -> Adam step. Turns on the gradients of the parameters `opt`
    holds (every one, as get_optimizer builds it) and off those of the
    rest of the trained model, so that backward runs only toward what
    trains (the teacher stays frozen). painting: the texture-painting
    step, whose paint batch Trainer.render_and_loss takes to the painting
    objective (N_rays, H, W unused); it counts paint.rows_trained under a
    profiler. grad_mask {parameter name: tensor}: each gradient is
    multiplied by its mask (broadcast) after backward; a parameter the
    dict does not name keeps its gradient. debug_nans: a non-finite total
    loss raises FloatingPointError before backward."""
    trained = {id(p) for _, p in opt.params}
    for p in trainer.model.parameters():
        p.requires_grad_(id(p) in trained)
    device = trainer.model.device
    params = dict(trainer.model.named_parameters())

    @spanned("train.step")
    def train_step(model_input, ground_truth, generator, select_inds=None):
        _set_matmul_precision(matmul_precision, device)
        opt.zero_grad()
        with span("train.forward"):
            ret = trainer.render_and_loss(
                model_input, ground_truth, render_kwargs_train, N_rays, H,
                W, generator=generator, select_inds=select_inds)
        total = ret["losses"]["total"]
        if debug_nans:
            count("host_read")          # blocks: a read back to the host
            if not bool(torch.isfinite(total)):
                raise FloatingPointError(
                    f"non-finite total loss {float(total.detach())}")
        scalars = {k: v.detach() for k, v in ret["losses"].items()}
        with span("train.backward"):
            total.backward()
            if grad_mask is not None:
                with torch.no_grad():
                    for name, m in grad_mask.items():
                        if params[name].grad is not None:
                            params[name].grad.mul_(m)
            if painting and enabled():
                count_device("paint.rows_trained", torch.any(
                    params["color_features"].grad != 0, dim=-1))
            if dist.is_initialized():
                # each rank's terms average to the global batch's
                all_reduce_grads([p for _, p in opt.params])
                keys = list(scalars)
                mean = global_sum(torch.stack([scalars[k] for k in keys])) \
                    / dist.process_count()
                scalars = dict(zip(keys, mean))
        scalars["psnr"] = ret["extras"]["psnr"].detach()
        scalars.update(ret["extras"].get("scalars", {}))
        with span("train.grad_norm"), torch.no_grad():
            scalars["grad_norm"] = torch.sqrt(sum(
                torch.sum(p.grad * p.grad) for _, p in opt.params
                if p.grad is not None))
        opt.step()
        return scalars["total"], scalars

    return train_step


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


@torch.no_grad()
def validate(model, renderer, val_dataset, view_idx, render_kwargs_test,
             logger: Logger, it: int, calc_normal: bool = True):
    """Full-image validation render of one view: its images and PSNR into
    the logger. Returns the PSNR."""
    from ..ops.rays import get_rays

    _, sample, gt = val_dataset[view_idx]
    H, W = val_dataset.H, val_dataset.W
    dev = model.device
    ro, rd = get_rays(torch.as_tensor(sample["c2w"], device=dev),
                      torch.as_tensor(sample["intrinsics"], device=dev), H, W)
    kwargs = {k: v for k, v in render_kwargs_test.items() if k != "batched"}
    kwargs["calc_normal"] = calc_normal
    rgb, depth, extras = renderer(ro, rd, detailed_output=False, **kwargs)
    rgb_im = rgb.reshape(H, W, 3).cpu().numpy()
    depth_im = depth.reshape(H, W).cpu().numpy()
    acc_im = extras["mask_volume"].reshape(H, W).cpu().numpy()
    logger.add_imgs(rgb_im, "val/predicted_rgb", it)
    logger.add_imgs(np.asarray(gt["rgb"]).reshape(H, W, 3), "val/gt_rgb", it)
    dmax = depth_im.max() + 1e-9
    logger.add_imgs(np.stack([depth_im / dmax] * 3, -1), "val/pred_depth", it)
    logger.add_imgs(np.stack([np.clip(acc_im, 0, 1)] * 3, -1),
                    "val/pred_mask", it)
    if "normals_volume" in extras:
        n_im = extras["normals_volume"].reshape(H, W, 3).cpu().numpy()
        logger.add_imgs(n_im / 2.0 + 0.5, "val/pred_normals", it)
    mse = float(np.mean((rgb_im.reshape(-1, 3) - np.asarray(gt["rgb"])) ** 2))
    psnr = -10.0 * np.log10(mse + 1e-12)
    logger.add("validation", "psnr", psnr, it)
    return psnr


def main_function(args):
    """Train args.model.framework on args.device (default the card; under
    a process group this rank's card), joining the group that torchrun's
    or SLURM's environment describes. Returns {"model", "trainer",
    "optimizer", "render_kwargs_train", "it", "exp_dir"}."""
    own_group = not dist.is_initialized()
    dist.init_env(args, seed=SEED)
    try:
        with contextlib.ExitStack() as stack:
            return _train(args, stack)
    finally:
        if own_group:
            dist.shutdown()


def _train(args, stack):
    device = resolve_device(args.get("device", None) or "cuda")
    grid = get_global_mesh(args.training.get("use_device_mesh", True))
    master = dist.is_master()
    exp_dir = os.path.join(args.training.log_root_dir, args.expname)
    args.training.exp_dir = exp_dir
    debug_nans = bool(args.training.get("debug_nans", False))
    if debug_nans:
        stack.enter_context(torch.autograd.detect_anomaly(check_nan=True))
    profile_dir = args.training.get("profile_dir", None)
    if profile_dir and master:
        stack.enter_context(_profiled(profile_dir, device))
    logger = Logger(log_dir=exp_dir, img_dir=os.path.join(exp_dir, "imgs"),
                    monitoring=args.training.get("monitoring", "none"),
                    monitoring_dir=os.path.join(exp_dir, "events"))
    if master:
        backup_sources(os.path.join(exp_dir, "backup"))
        save_yaml(args, os.path.join(exp_dir, "config.yaml"))

    train_dataset, val_dataset = get_data(
        args, return_val=True,
        val_downscale=args.data.get("val_downscale", 4.0))
    H, W = train_dataset.H, train_dataset.W
    model, trainer, render_kwargs_train, render_kwargs_test, renderer = \
        build_framework(args, args.model.framework, device=device,
                        seed=SEED)
    log.info(f"=> Experiment: {args.expname} | H,W=({H},{W}) | "
             f"device={device} | grid {grid.batch} x {grid.data}")
    maybe_pretrain_siren(args, model, logger)
    # each update advances the global iteration by the batch axis's size;
    # the schedule reads the global it
    step = grid.batch
    opt = get_optimizer(args, model, step_scale=step)

    ckpt_io = CheckpointIO(os.path.join(exp_dir, "ckpts"))
    it = 0
    ckpt_file = args.training.get("ckpt_file", None)
    if ckpt_file is None or ckpt_file == "None":
        ckpt_file = ckpt_io.latest_path()
    ignore = args.training.get("ckpt_ignore_keys", None) or None
    if ckpt_file is not None and os.path.exists(str(ckpt_file)):
        log.info(f"=> Loading checkpoint {ckpt_file}")
        loaded = ckpt_io.load_file(
            str(ckpt_file), model, ignore_keys=ignore,
            only_use_keys=args.training.get("ckpt_only_use_keys", None)
            or None)
        it = int(loaded.get("global_step", 0))
        if "optimizer" in loaded and not ignore:
            try:
                opt.load_state_dict(loaded["optimizer"])
            except (KeyError, TypeError, RuntimeError) as e:
                log.warning(f"optimizer state not restored: {e}")
    broadcast_params(model.parameters())

    train_step = build_train_step(
        trainer, opt, render_kwargs_train, args.data.N_rays, H, W,
        matmul_precision=args.training.get("matmul_precision", "default"),
        debug_nans=debug_nans)
    num_iters = args.training.num_iters
    # intervals are divided by the batch axis's size, as `it` advances by it
    i_val = args.training.get("i_val", 500)
    i_backup = args.training.get("i_backup", 50000)
    if step > 1:
        i_val = i_val // step if i_val > 0 else i_val
        i_backup = i_backup // step if i_backup > 0 else i_backup
    i_save_sec = args.training.get("i_save", 900)
    i_log = args.training.get("i_log", 20)
    batch_size = args.data.get("batch_size", 1) or 1
    if step > 1 and len(train_dataset) < batch_size * step:
        raise ValueError(
            f"dataset has {len(train_dataset)} images < batch_size x hosts "
            f"= {batch_size}x{step}; shrink batch_size or the number of "
            "hosts")
    # the same rng state on every rank: the shared epoch order, the val
    # view, and (ShardedGenerator) the rays and perturbations at the global
    # batch's shape
    data_rng = np.random.default_rng(SEED)
    generator = torch.Generator(device=device).manual_seed(SEED)
    if dist.is_initialized():
        generator = ShardedGenerator(generator, grid, batch_size)
    t0 = t_last_save = time.time()
    t_last_log, it_last_log = time.time(), it

    def save(name):
        if master:
            ckpt_io.save(name, model=model, optimizer=opt.state_dict(),
                         global_step=it, epoch_idx=0)
        logger.flush()

    def due(interval, it_before, it_after):
        return interval > 0 and it_before // interval != it_after // interval

    def _result():
        return {"model": model, "trainer": trainer, "optimizer": opt,
                "render_kwargs_train": render_kwargs_train, "it": it,
                "exp_dir": exp_dir}

    try:
        while it < num_iters:
            for _, model_input, ground_truth in train_dataset.epoch_batches(
                    batch_size * step, data_rng):
                if it >= num_iters:
                    break
                model_input = to_device(make_global_batch(grid, model_input),
                                        device)
                ground_truth = to_device(
                    make_global_batch(grid, ground_truth), device)
                if due(i_val, it - step, it):
                    view_idx = int(data_rng.integers(len(val_dataset)))
                    if master:
                        psnr = validate(
                            model, renderer, val_dataset, view_idx,
                            render_kwargs_test, logger, it,
                            calc_normal=render_kwargs_train.get(
                                "calc_normal", False))
                        log.info(f"[val] it {it}: psnr {psnr:.2f}")
                total, scalars = train_step(model_input, ground_truth,
                                            generator)
                it_prev, it = it, it + step
                if due(i_log, it_prev, it):
                    total_f = float(total)          # device sync
                    now = time.time()
                    dt_it = (now - t_last_log) / max(it - it_last_log, 1)
                    t_last_log, it_last_log = now, it
                    rays_s = args.data.N_rays * batch_size / max(dt_it, 1e-9)
                    log.info(f"it {it}/{num_iters} loss {total_f:.4f} psnr "
                             f"{float(scalars['psnr']):.2f} "
                             f"({dt_it * 1e3:.1f} ms/it, {rays_s:,.0f} "
                             "rays/s)")
                    logger.add("learning_rates", "whole",
                               current_lr(args, it), it)
                    for k, v in scalars.items():
                        logger.add("losses" if k.startswith("loss")
                                   or k == "total" else "extras", k,
                                   float(v), it)
                if time.time() - t_last_save > i_save_sec:
                    save("latest.ckpt")
                    t_last_save = time.time()
                if due(i_backup, it_prev, it):
                    save(f"{it:08d}.ckpt")
    except KeyboardInterrupt:
        log.info("=> KeyboardInterrupt: saving latest and exiting")
        save("latest.ckpt")
        return _result()

    save("latest.ckpt")
    save(f"final_{it:08d}.ckpt")
    log.info(f"=> Training done in {time.time() - t0:.1f}s ({it} "
             "iterations)")
    return _result()


@contextlib.contextmanager
def _profiled(profile_dir: str, device):
    """A torch.profiler trace (CPU, and CUDA on the card) of the block,
    written as a Chrome trace to profile_dir/trace_rank<rank>.json."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(profile_dir, f"trace_rank{dist.process_index()}.json")
    prof.export_chrome_trace(path)
    log.info(f"=> profiler trace: {path}")
