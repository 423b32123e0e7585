"""SIREN-SDF sphere pretraining hook (counterpart of
neumesh_tpu/train/pretrain.py): before the main training, a SIREN
implicit surface is fitted to the analytic sphere of its radius_init so
the geometric-init assumption holds."""
from __future__ import annotations

import torch

from ..models.base import pretrain_siren_sdf_loss
from ..utils.print_fn import log


def maybe_pretrain_siren(args, model, logger=None, generator=None):
    """Fit model.implicit_surface (when it is a geometric-init SIREN) to
    its sphere with plain Adam; other models are left as they are.
    Returns the model."""
    surface = getattr(model, "implicit_surface", None)
    if surface is None or not getattr(surface, "use_siren", False):
        return model
    if not getattr(surface, "geometric_init", True):
        return model
    num_iters = int(args.training.get("pretrain_num_iters", 5000))
    lr = float(args.training.get("pretrain_lr", 1.0e-4))
    batch_points = int(args.training.get("pretrain_batch_points", 5000))
    bound = surface.obj_bounding_size
    log.info(f"=> pretraining SIREN sdf to sphere r={surface.radius_init} "
             f"({num_iters} iters)")
    params = [p for p in surface.parameters()]
    flags = [p.requires_grad for p in params]
    surface.requires_grad_(True)
    opt = torch.optim.Adam(params, lr=lr)
    dev = next(iter(params)).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(31)
    loss = torch.zeros(())
    for i in range(num_iters):
        pts = (torch.rand((batch_points, 3), generator=generator, device=dev)
               * 2.0 - 1.0) * bound
        opt.zero_grad()
        loss = pretrain_siren_sdf_loss(surface, pts)
        loss.backward()
        opt.step()
        if logger is not None and i % 100 == 0:
            logger.add("pretrain_siren", "loss_l1", float(loss), i)
    for p, f in zip(params, flags):
        p.requires_grad_(f)
        p.grad = None
    log.info(f"=> SIREN pretraining done, final l1 {float(loss):.4f}")
    return model
