"""DVR-style root finding (counterpart of neumesh_tpu/render/ray_casting.py
run_secant_method and root_finding_surface_points). Sign convention:
(+) outside, (-) inside."""
from __future__ import annotations

import torch

from ..ops.kernels import secant_pred


def run_secant_method(f_low, f_high, d_low, d_high, rays_o, rays_d,
                      surface_query_fn, n_secant_steps: int,
                      logit_tau: float = 0.0):
    """Vectorised secant iteration; every ray iterates (invalid ones are
    masked by the caller)."""
    d_pred = secant_pred(f_low, f_high, d_low, d_high)
    for _ in range(n_secant_steps):
        f_mid = surface_query_fn(rays_o + d_pred[..., None] * rays_d) \
            - logit_tau
        low = f_mid < 0
        d_low = torch.where(low, d_pred, d_low)
        f_low = torch.where(low, f_mid, f_low)
        d_high = torch.where(low, d_high, d_pred)
        f_high = torch.where(low, f_high, f_mid)
        d_pred = secant_pred(f_low, f_high, d_low, d_high)
    return d_pred


def root_finding_surface_points(surface_query_fn, rays_o, rays_d, near, far,
                                N_steps: int = 256, logit_tau: float = 0.0,
                                N_secant_steps: int = 8,
                                fill_inf: bool = True, refine_query_fn=None,
                                secant_override=None,
                                rebracket: bool = True):
    """N_steps sign-change scan of surface_query_fn over [near, far] (R,),
    then secant refinement on refine_query_fn (the true density) when
    given. With secant_override the refinement is one fused launch and a
    re-bracket at the half-step-widened scan endpoints is folded into it.
    Returns (d_pred (R,), pt_pred (R, 3), mask, mask_sign_change)."""
    R = rays_o.shape[0]
    dev = rays_o.device
    t = torch.linspace(0.0, 1.0, N_steps, device=dev)
    d_proposal = near[..., None] * (1 - t) + far[..., None] * t
    p_proposal = rays_o[:, None, :] + d_proposal[..., None] * rays_d[:, None, :]
    val = surface_query_fn(p_proposal) - logit_tau             # (R, N_steps)

    mask_0_not_occupied = val[..., 0] > 0
    sign_matrix = torch.cat(
        [torch.sign(val[..., :-1] * val[..., 1:]),
         torch.ones((R, 1), device=dev)], dim=-1)
    cost_matrix = sign_matrix * torch.arange(
        N_steps, 0, -1, device=dev, dtype=torch.float32)
    values = torch.amin(cost_matrix, dim=-1)
    indices = torch.argmin(cost_matrix, dim=-1)     # first minimum
    mask_sign_change = values < 0
    idx1 = torch.clamp(indices + 1, max=N_steps - 1)
    f_high = torch.gather(val, -1, indices[:, None])[:, 0]
    d_high = torch.gather(d_proposal, -1, indices[:, None])[:, 0]
    f_low = torch.gather(val, -1, idx1[:, None])[:, 0]
    d_low = torch.gather(d_proposal, -1, idx1[:, None])[:, 0]
    mask = mask_sign_change & (f_high > 0) & mask_0_not_occupied

    do_rebracket = refine_query_fn is not None and rebracket
    fold = do_rebracket and secant_override is not None
    step = (far - near) / max(N_steps - 1, 1)
    if do_rebracket and not fold:
        d_high_w = torch.maximum(d_high - 0.5 * step, near)
        d_low_w = torch.minimum(d_low + 0.5 * step, far)
        f_high_r = refine_query_fn(
            rays_o + d_high_w[..., None] * rays_d) - logit_tau
        f_low_r = refine_query_fn(
            rays_o + d_low_w[..., None] * rays_d) - logit_tau
        ok = (f_high_r > 0) & (f_low_r < 0)
        f_high = torch.where(ok, f_high_r, f_high)
        f_low = torch.where(ok, f_low_r, f_low)
        d_high = torch.where(ok, d_high_w, d_high)
        d_low = torch.where(ok, d_low_w, d_low)

    if secant_override is not None:
        kw = {}
        if fold:
            kw["d_high_w"] = torch.maximum(d_high - 0.5 * step, near)
            kw["d_low_w"] = torch.minimum(d_low + 0.5 * step, far)
        d_pred = secant_override(f_low, f_high, d_low, d_high,
                                 N_secant_steps, logit_tau, **kw)
    else:
        secant_fn = (refine_query_fn if refine_query_fn is not None
                     else surface_query_fn)
        d_pred = run_secant_method(f_low, f_high, d_low, d_high, rays_o,
                                   rays_d, secant_fn, N_secant_steps,
                                   logit_tau)

    pt_pred = torch.where(mask[..., None],
                          rays_o + d_pred[..., None] * rays_d,
                          torch.ones_like(rays_o))
    miss = torch.full_like(far, float("inf")) if fill_inf else far
    d_out = torch.where(mask, d_pred, miss)
    d_out = torch.where(mask_0_not_occupied, d_out, torch.zeros_like(d_out))
    return d_out, pt_pred, mask, mask_sign_change
