"""Trainer: ray sampling, rendering and losses (counterpart of
neumesh_tpu/train/trainer.py).

Trainer.render_and_loss samples N_rays pixels of each view, renders them
with every detailed output the losses read, and returns compute_loss's
{"losses", "extras"}: the total is a differentiable scalar for
backward(). The distillation teacher runs under torch.no_grad, so its
targets carry no gradient. On a paint batch render_and_loss is the
texture-painting objective of the editing CLI (render_and_loss_painting):
paint rays rendered with random colour directions, background rays with
distillation.

Under a process group (data parallel, parallel/mesh.py) every loss that
divides by a data-dependent count divides by the group's count, and the
psnr is the group's; plain means over equal per-rank counts need nothing.
"""
from __future__ import annotations

import torch

from ..ops import rays as rays_ops
from ..ops.metrics import psnr
from ..parallel import dist, global_sum
from ..render.volume import volume_render_rays
from ..utils.trace import count, span, spanned

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "float32": None, "f32": None}


def _masked_mean(total, count, eps=0.0, clamp=None):
    """total / (count + eps), or total / max(count, clamp). Under a
    process group the count is the group's (global_sum) and the quotient
    is scaled by the world size: all_reduce_grads averages the ranks, so
    the gradient is that of the global batch's masked mean."""
    world = 1
    if dist.is_initialized():
        world, count = dist.process_count(), global_sum(count)
    den = count + eps if clamp is None else torch.clamp(count, min=clamp)
    return total / den if world == 1 else world * total / den


def density_distill_loss(density_pred, density_gt, density_clip=None):
    """SDF distillation L1. density_clip=None: the plain mean the reference
    ships; a float: the L1 averaged over |teacher sdf| <= clip (over the
    group's samples under a process group, see _masked_mean)."""
    l1 = torch.abs(density_gt - density_pred)
    if density_clip is None:
        return torch.mean(l1)
    mask = torch.abs(density_gt) <= density_clip
    return _masked_mean(torch.sum(torch.where(mask, l1, torch.zeros_like(l1))),
                        torch.sum(mask), clamp=1)


def _psnr(rgb, target_rgb, valid_mask=None):
    """metrics.psnr; under a process group, of the group's rays (the
    squared error and its count summed over the ranks)."""
    if not dist.is_initialized():
        return psnr(rgb, target_rgb, valid_mask=valid_mask)
    err = ((rgb - target_rgb) ** 2).detach()
    if valid_mask is None:
        n = torch.tensor(float(err.numel()), device=err.device)
    else:
        err = torch.where(valid_mask, err, torch.zeros_like(err))
        n = torch.sum(valid_mask).float() * (err.numel()
                                             // valid_mask.numel())
    sums = global_sum(torch.stack([torch.sum(err), n]))
    return -10.0 * torch.log10(sums[0] / torch.clamp(sums[1], min=1))


def _take(x, inds):
    """x (B, H*W, ...) at select_inds (B, N) -> (B, N, ...)."""
    idx = inds.reshape(inds.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(inds.shape + x.shape[2:]))


class Trainer:
    def __init__(self, model, loss_weights: dict, teacher_model=None,
                 distill_density_clip=None, teacher_dtype=None):
        """distill_density_clip: see density_distill_loss. teacher_dtype:
        the dtype of the teacher's no-grad evaluations (e.g. "bfloat16",
        under autocast on the card); None keeps it in f32."""
        self.model = model
        self.loss_weights = loss_weights
        self.teacher_model = teacher_model
        self.distill_density_clip = distill_density_clip
        if isinstance(teacher_dtype, str):
            teacher_dtype = _DTYPES[teacher_dtype]
        self.teacher_dtype = teacher_dtype

    def render_and_loss(self, model_input: dict, ground_truth: dict,
                        render_kwargs_train: dict, N_rays: int, H: int,
                        W: int, generator=None, select_inds=None):
        """model_input {"c2w" (B, 4, 4), "intrinsics" (B, 4, 4),
        "object_mask" (B, H*W)}, ground_truth {"rgb" (B, H*W, 3)} as
        tensors on the model's device. N_rays pixels a view are drawn from
        `generator` (or select_inds is used); the same generator draws the
        render's perturbations. A parallel.ShardedGenerator draws them at
        the global batch's shape and keeps this rank's rays (N_rays is
        then the global count a view). A paint batch (model_input holds
        "rays_o_paint") takes the texture-painting objective,
        render_and_loss_painting (N_rays, H, W and select_inds unused)."""
        if "rays_o_paint" in model_input:
            return self.render_and_loss_painting(
                model_input, ground_truth, render_kwargs_train,
                generator=generator)
        w = self.loss_weights
        use_distill = w["distill_density"] > 0 or w["distill_color"] > 0
        use_eikonal = w["eikonal"] > 0
        with span("train.render"):
            rays_o, rays_d, select_inds = rays_ops.get_rays(
                model_input["c2w"], model_input["intrinsics"], H, W,
                N_rays=N_rays, generator=generator, select_inds=select_inds)
            extras = volume_render_rays(
                self.model, rays_o, rays_d, detailed_output=True,
                samples_output=use_distill,
                calc_normal=use_eikonal or render_kwargs_train.get(
                    "calc_normal", False),
                generator=generator,
                **{k: v for k, v in render_kwargs_train.items()
                   if k not in ("calc_normal", "rayschunk", "batched")})
        target_rgb = _take(ground_truth["rgb"], select_inds)
        target_mask = None
        if w["mask"] > 0:
            target_mask = _take(model_input["object_mask"], select_inds)
        mask_ignore = None
        if "mask_ignore" in model_input:
            mask_ignore = _take(model_input["mask_ignore"], select_inds)
        ret = self.compute_loss(
            extras["rgb"], target_rgb, extras, mask=target_mask,
            mask_ignore=mask_ignore, use_distill_loss=use_distill,
            use_eikonal_loss=use_eikonal,
            use_indicator_reg=w["indicator_reg"] > 0)
        ret["extras"]["select_inds"] = select_inds
        return ret

    def render_and_loss_painting(self, model_input: dict, ground_truth: dict,
                                 render_kwargs_train: dict, generator=None):
        """The texture-painting objective: the paint rays rendered with
        random colour directions (view independence), the background rays
        with the distillation samples; the losses over both groups
        concatenated, distillation on. model_input {"rays_o_paint",
        "rays_d_paint", "mask_paint", "rays_o_bg", "rays_d_bg", "mask_bg"}
        and ground_truth {"rgb_paint", "rgb_bg"} as (B, ...) tensors;
        `generator` draws the paint group's directions and both groups'
        perturbations, paint first. Each group renders in its own span,
        train.paint_rays and train.background_rays."""
        kw = {k: v for k, v in render_kwargs_train.items()
              if k not in ("calc_normal", "rayschunk", "batched")}
        count("paint.rays", model_input["rays_o_paint"].shape[0]
              + model_input["rays_o_bg"].shape[0])

        def render_group(suffix, samples_output, random_direction):
            with span("train.paint_rays" if random_direction
                      else "train.background_rays"):
                extras = volume_render_rays(
                    self.model, model_input["rays_o_" + suffix][:, None, :],
                    model_input["rays_d_" + suffix][:, None, :],
                    detailed_output=True, samples_output=samples_output,
                    random_color_direction=random_direction,
                    generator=generator, **kw)
            return (extras["rgb"], ground_truth["rgb_" + suffix][:, None, :],
                    model_input["mask_" + suffix][:, None], extras)

        rgb_p, tgt_p, mask_p, extras_p = render_group("paint", False, True)
        rgb_b, tgt_b, mask_b, extras_b = render_group("bg", True, False)
        extras = dict(extras_b)
        # background first, as the JAX package orders it (the mask targets
        # are all ones, so the order does not change the loss)
        extras["mask_volume"] = torch.cat(
            [extras_b["mask_volume"], extras_p["mask_volume"]], 0)
        return self.compute_loss(
            torch.cat([rgb_p, rgb_b], 0), torch.cat([tgt_p, tgt_b], 0),
            extras, mask=torch.cat([mask_p, mask_b], 0),
            use_distill_loss=True)

    @spanned("train.teacher")
    def _teacher(self, xyz, dirs):
        """Teacher (sdf, radiance) at the distillation samples, without
        gradient, in f32."""
        with torch.no_grad():
            if self.teacher_dtype is None:
                sdf, rad = self.teacher_model.forward(xyz, dirs)
            else:
                with torch.autocast(xyz.device.type,
                                    dtype=self.teacher_dtype):
                    sdf, rad = self.teacher_model.forward(xyz, dirs)
        return sdf.float(), rad.float()

    @spanned("train.loss")
    def compute_loss(self, rgb, target_rgb, extras: dict, mask=None,
                     mask_ignore=None, use_eikonal_loss: bool = False,
                     use_distill_loss: bool = False,
                     use_indicator_reg: bool = False):
        """Losses with the reference's epsilon and clamp placement:
        {"losses": {"loss_img", ["loss_eikonal", "loss_density",
        "loss_color", "loss_indicator_vector_reg", "loss_mask"], "total"},
        "extras": {..., "psnr", "scalars"}}."""
        w = self.loss_weights
        losses = {}
        out_extras = dict(extras)
        if use_eikonal_loss:
            nablas = extras["implicit_nablas"]
            # safe norm: a zero vector gets gradient 0, not NaN
            nablas_norm = torch.sqrt(torch.sum(nablas * nablas, dim=-1)
                                     + 1e-12)
        mask_volume = torch.clamp(extras["mask_volume"], 1e-3, 1 - 1e-3)
        out_extras["mask_volume_clipped"] = mask_volume
        loss_img = w["img"] * torch.abs(rgb - target_rgb)

        if use_eikonal_loss:
            losses["loss_eikonal"] = w["eikonal"] * torch.mean(
                (nablas_norm - 1.0) ** 2)
        if use_distill_loss:
            if self.teacher_model is None:
                raise ValueError("distillation losses need a teacher: set "
                                 "training.teacher_config / teacher_ckpt")
            gt_sdf, gt_rad = self._teacher(extras["xyz"], extras["dirs"])
            losses["loss_density"] = w["distill_density"] * \
                density_distill_loss(extras["density"], gt_sdf[..., None],
                                     self.distill_density_clip)
            losses["loss_color"] = w["distill_color"] * torch.mean(
                (extras["colors"] - gt_rad) ** 2)
        if use_indicator_reg:
            losses["loss_indicator_vector_reg"] = w["indicator_reg"] * \
                torch.mean((self.model.indicator_vector
                            - self.model.mesh_grid.vertex_normals) ** 2)
        if mask is not None:
            tm = mask.to(torch.float32)
            # BCE on the clamped accumulation
            losses["loss_mask"] = w["mask"] * torch.mean(
                -(tm * torch.log(mask_volume)
                  + (1 - tm) * torch.log(1 - mask_volume)))
            target_mask = mask if mask_ignore is None else (mask
                                                            & mask_ignore)
            tmf = target_mask.to(torch.float32)
            losses["loss_img"] = _masked_mean(
                torch.sum(loss_img * tmf[..., None]), torch.sum(tmf),
                eps=1e-10)
            out_extras["psnr"] = _psnr(rgb, target_rgb,
                                       valid_mask=target_mask[..., None])
        elif mask_ignore is not None:
            mi = mask_ignore.to(torch.float32)
            losses["loss_img"] = _masked_mean(
                torch.sum(loss_img * mi[..., None]), torch.sum(mi),
                eps=1e-10)
            out_extras["psnr"] = _psnr(rgb, target_rgb,
                                       valid_mask=mask_ignore[..., None])
        else:
            losses["loss_img"] = torch.mean(loss_img)
            out_extras["psnr"] = _psnr(rgb, target_rgb)

        losses["total"] = sum(losses.values())
        if use_eikonal_loss:
            out_extras["implicit_nablas_norm"] = nablas_norm
        scalars = {"1/s": 1.0 / self.model.forward_s().detach()}
        if use_indicator_reg and getattr(self.model, "learn_indicator_weight",
                                         False):
            scalars["indicator_weight"] = \
                self.model.forward_indicator_weight().detach()
        out_extras["scalars"] = scalars
        return {"losses": losses, "extras": out_extras}
