"""NeuS-CDF volume rendering over tile-shared candidate contexts
(counterpart of neumesh_tpu/render/volume.py, the tiled branch).

Two sampling structures:
  reference: N_samples coarse depths, N_upsample_iters rounds of NeuS
    hierarchical up-sampling, colour at every midpoint (the f32 parity
    anchor);
  root-anchored serving (root_anchored=True): a distance-proxy scan +
    fused secant (density re-bracket folded in) locates the first
    crossing, root_n_fine samples are concentrated around it, colour at
    the color_topk highest-visibility midpoints.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device, set_fp32_precision
from ..ops.alpha import alpha_to_w, cdf_Phi_s, sdf_to_alpha
from ..ops.rays import (block_order_indices, get_rays, near_far_from_sphere,
                        sample_pdf)
from .ray_casting import root_finding_surface_points


def root_anchored_depths(near, far, d_root, mask, N_fine: int, window,
                         win_frac: float = 0.5):
    """Sorted per-ray depths concentrated around a located root: three
    uniform segments [near, lo), [lo, hi), [hi, far] with the dense middle
    of half-width `window`; rays without a root (mask False) get N_fine
    uniform depths over [near, far]. near/far (R, 1); d_root/mask (R,)."""
    dev = near.device
    near0, far0 = near[..., 0], far[..., 0]
    half = 0.5 * (far0 - near0)
    c = torch.where(mask, torch.minimum(torch.maximum(d_root, near0), far0),
                    0.5 * (near0 + far0))
    w = torch.where(mask, torch.minimum(torch.as_tensor(window, device=dev),
                                        half), half)
    lo = torch.minimum(torch.maximum(c - w, near0), far0)
    hi = torch.minimum(torch.maximum(c + w, near0), far0)
    n_win = max(1, int(round(N_fine * win_frac)))
    n_lo = max(1, (N_fine - n_win) // 2)
    n_hi = max(1, N_fine - n_win - n_lo)

    def ar(n):
        return torch.arange(n, device=dev, dtype=torch.float32) / n

    t_lo = near0[..., None] + (lo - near0)[..., None] * ar(n_lo)
    t_win = lo[..., None] + (hi - lo)[..., None] * ar(n_win)
    t_hi = hi[..., None] + (far0 - hi)[..., None] * _linspace(n_hi, dev)
    d_anchor = torch.cat([t_lo, t_win, t_hi], dim=-1)
    d_unif = near0[..., None] + (far0 - near0)[..., None] * _linspace(
        N_fine, dev)
    return torch.where(mask[..., None], d_anchor, d_unif)


def _linspace(n, device):
    return torch.linspace(0.0, 1.0, n, device=device)


def volume_render_rays(model, rays_o, rays_d, *, ray_tile: int = 128,
                       tile_max_candidates=None,
                       obj_bounding_radius: float = 1.0,
                       white_bkgd: bool = False,
                       bounded_near_far: bool = True, perturb: bool = False,
                       generator=None, N_samples: int = 64,
                       N_importance: int = 64, N_upsample_iters: int = 4,
                       phi_s_base: float = 256.0,
                       reuse_upsample_sdf: bool = False, color_topk: int = 0,
                       root_anchored: bool = False, root_steps: int = 16,
                       root_secant: int = 3, root_n_fine: int = 48,
                       root_window: float = 0.0, root_win_frac: float = 0.5):
    """Render one chunk of (R, 3) rays through the tile-shared candidate
    binding (R a multiple of ray_tile, rays in tile order). rays_d need
    not be normalised. Returns {"rgb" (R, 3), "depth_volume" (R,),
    "mask_volume" (R,)}."""
    rays_o = rays_o.to(torch.float32)
    rays_d = rays_d.to(torch.float32)
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    near, far = near_far_from_sphere(rays_o, rays_d, r=obj_bounding_radius)
    tb = model.bind_rays_tiled(rays_o, rays_d, near, far, tile=ray_tile,
                               max_candidates=tile_max_candidates)
    if tb is None:
        raise ValueError(
            "volume_render_rays needs the tiled candidate binding: ray_tile "
            f"> 1 dividing the ray count (ray_tile={ray_tile}, "
            f"rays={rays_o.shape[0]})")
    bound, near_t, far_t = tb
    if bounded_near_far:
        near, far = near_t, far_t

    d_all = None
    if root_anchored:
        def scan_fn(pts):
            return bound.compute_distance(pts)[..., 0]

        def refine_fn(pts):
            return bound.forward_density_only(pts[:, None, :])[..., 0]

        def secant_override(f_low, f_high, d_low, d_high, n, tau,
                            d_low_w=None, d_high_w=None):
            return bound.fused_secant(rays_o, rays_d, d_low, d_high, f_low,
                                      f_high, n_iters=n, logit_tau=tau,
                                      d_low_w=d_low_w, d_high_w=d_high_w)

        d_pred, _, mask, _ = root_finding_surface_points(
            scan_fn, rays_o, rays_d, near=near[..., 0], far=far[..., 0],
            N_steps=root_steps, N_secant_steps=root_secant, fill_inf=False,
            refine_query_fn=refine_fn, secant_override=secant_override,
            rebracket=model.secant_rebracket)
        s_val = model.forward_s()
        win = (root_window if root_window
               else torch.clamp(6.0 / s_val, 0.02, 0.5))
        d_all = root_anchored_depths(near, far, d_pred, mask, root_n_fine,
                                     win, root_win_frac)

    return _render_core(
        bound, rays_o, rays_d, near, far, white_bkgd=white_bkgd, perturb=perturb, generator=generator,
        N_samples=N_samples, N_importance=N_importance,
        N_upsample_iters=N_upsample_iters, phi_s_base=phi_s_base,
        reuse_upsample_sdf=reuse_upsample_sdf, color_topk=color_topk,
        d_all_override=d_all)


def _render_core(model, rays_o, rays_d, near, far, *, white_bkgd, perturb, generator, N_samples, N_importance,
                 N_upsample_iters, phi_s_base, reuse_upsample_sdf,
                 color_topk=0, d_all_override=None):
    """Sampling + up-sampling + evaluation + compositing on a bound model
    with near/far resolved; d_all_override supplies sorted depths (the
    root-anchored structure) in place of coarse + up-sampling."""
    dev = rays_o.device

    def at(d):
        return rays_o[:, None, :] + d[..., None] * rays_d[:, None, :]

    if d_all_override is not None:
        d_all = d_all_override
        sdf = model.forward_density_only(at(d_all))
    else:
        _t = _linspace(N_samples, dev)
        d = near * (1 - _t) + far * _t
        sdf_up = model.forward_density_only(at(d))
        n_per = N_importance // N_upsample_iters
        for i in range(N_upsample_iters):
            prev_sdf, next_sdf = sdf_up[..., :-1], sdf_up[..., 1:]
            prev_z, next_z = d[..., :-1], d[..., 1:]
            mid_sdf = (prev_sdf + next_sdf) * 0.5
            dot_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
            prev_dot = torch.cat([torch.zeros_like(dot_val[..., :1]),
                                  dot_val[..., :-1]], dim=-1)
            dot_val = torch.clamp(torch.minimum(prev_dot, dot_val), -10.0,
                                  0.0)
            dist = next_z - prev_z
            prev_esti = mid_sdf - dot_val * dist * 0.5
            next_esti = mid_sdf + dot_val * dist * 0.5
            s_i = phi_s_base * (2 ** i)
            prev_cdf = cdf_Phi_s(prev_esti, s_i)
            next_cdf = cdf_Phi_s(next_esti, s_i)
            alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
            d_fine = sample_pdf(d, alpha_to_w(alpha), n_per,
                                det=not perturb, generator=generator)
            sdf_fine = model.forward_density_only(at(d_fine))
            d = torch.cat([d, d_fine], dim=-1)
            sdf_up = torch.cat([sdf_up, sdf_fine], dim=-1)
            d, order = torch.sort(d, dim=-1, stable=True)
            sdf_up = torch.gather(sdf_up, -1, order)
        d_all = d
        sdf = (sdf_up if reuse_upsample_sdf
               else model.forward_density_only(at(d_all)))

    d_mid = 0.5 * (d_all[..., 1:] + d_all[..., :-1])
    _, alpha = sdf_to_alpha(sdf, model.forward_s())
    w = alpha_to_w(alpha)
    if color_topk and color_topk < d_mid.shape[-1]:
        # radiance only at the color_topk highest-visibility midpoints,
        # the selected mass renormalised to the ray's total
        order = torch.sort(-w, dim=-1, stable=True).indices[..., :color_topk]
        d_sel = torch.gather(d_mid, -1, order)
        w_sel = torch.gather(w, -1, order)
        pts = at(d_sel)
        _, rad = model.forward(pts, rays_d[:, None, :].expand_as(pts))
        renorm = (torch.sum(w, -1, keepdim=True)
                  / (torch.sum(w_sel, -1, keepdim=True) + 1e-10))
        rgb = torch.sum(w_sel[..., None] * rad, dim=-2) * renorm
    else:
        pts = at(d_mid)
        _, rad = model.forward(pts, rays_d[:, None, :].expand_as(pts))
        rgb = torch.sum(w[..., None] * rad, dim=-2)
    depth = torch.sum(w / (torch.sum(w, -1, keepdim=True) + 1e-10) * d_mid,
                      dim=-1)
    acc = torch.sum(w, dim=-1)
    if white_bkgd:
        rgb = rgb + (1.0 - acc[..., None])
    return {"rgb": rgb, "depth_volume": depth, "mask_volume": acc}


@torch.no_grad()
def volume_render(model, rays_o, rays_d, *, rayschunk: int = 0,
                  device="cuda", **kwargs):
    """Render (..., 3) rays in chunks of `rayschunk` (0: one chunk), the
    last chunk edge-padded. Returns (rgb, depth, extras)."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model on {model.device}, device={dev}")
    if dev.type == "cuda":
        set_fp32_precision()
    shape = rays_o.shape[:-1]
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    n = rays_o.shape[0]
    if rayschunk and n > rayschunk:
        outs = []
        for i in range(0, n, rayschunk):
            ro, rd = rays_o[i:i + rayschunk], rays_d[i:i + rayschunk]
            pad = rayschunk - ro.shape[0]
            if pad:
                ro = torch.cat([ro, ro[-1:].expand(pad, 3)], 0)
                rd = torch.cat([rd, rd[-1:].expand(pad, 3)], 0)
            outs.append(volume_render_rays(model, ro, rd, **kwargs))
        ret = {k: torch.cat([o[k] for o in outs], 0)[:n] for k in outs[0]}
    else:
        ret = volume_render_rays(model, rays_o, rays_d, **kwargs)
    ret = {k: v.reshape(shape + v.shape[1:]) for k, v in ret.items()}
    return ret["rgb"], ret["depth_volume"], ret


@torch.no_grad()
def render_image(model, c2w, K, H: int, W: int, *, block=(8, 16),
                 device="cuda", **kwargs):
    """One frame: camera rays -> block_h x block_w pixel-block order (tile
    contexts need compact ray bundles) -> chunked volume render -> back to
    raster order. c2w (4, 4), K (3|4, 3|4). Returns (rgb (H, W, 3),
    depth (H, W), extras)."""
    dev = resolve_device(device)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
    K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    rays_o, rays_d = get_rays(c2w, K, H, W)
    perm, inv = block_order_indices(H, W, *block)
    perm = torch.as_tensor(perm, device=dev)
    inv = torch.as_tensor(inv, device=dev)
    rgb, depth, ret = volume_render(model, rays_o[perm], rays_d[perm],
                                    device=device, **kwargs)
    ret = {k: v[inv].reshape(H, W, *v.shape[1:]) for k, v in ret.items()}
    return ret["rgb"], ret["depth_volume"], ret
