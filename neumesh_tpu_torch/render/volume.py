"""NeuS-CDF volume rendering (counterpart of neumesh_tpu/render/volume.py).

Rays bind to tile-shared candidate contexts (ray_tile > 1), or to
per-ray contexts after a closed-form mesh-bounded near/far (ray_tile 0,
the render CLI's default); a model without a candidate grid is queried
per sample, its near/far from a 256-probe distance scan.

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

import torch

from ..models.neumesh.model import candidate_bounded_near_far
from ..ops.alpha import alpha_to_w, cdf_Phi_s, sdf_to_alpha
from ..ops.rays import near_far_from_sphere, rand, sample_pdf
from ..utils.trace import span, spanned
from .frame import render_chunks, render_device, render_frame
from .ray_casting import root_finding_surface_points


@spanned("ctx.bounds")
def compute_bounded_near_far(model, rays_o, rays_d, near, far,
                             sample_grid: int = 256,
                             distance_thresh: float = 0.1):
    """near/far tightened to the segment where the interpolated mesh
    distance of sample_grid probes is below distance_thresh. near/far
    (R, 1)."""
    _t = _linspace(sample_grid, rays_o.device)
    d_coarse = near * (1 - _t) + far * _t
    pts = rays_o[:, None, :] + d_coarse[..., None] * rays_d[:, None, :]
    ds = model.compute_distance(pts)[0][..., 0]
    mask = ds < distance_thresh
    near_new = torch.amin(torch.where(mask, d_coarse,
                                      torch.full_like(d_coarse, 1e10)),
                          dim=-1, keepdim=True)
    near_new = torch.where(near_new > 1e5, near, near_new)
    far_new = torch.amax(torch.where(mask, d_coarse,
                                     torch.full_like(d_coarse, -1e10)),
                         dim=-1, keepdim=True)
    far_new = torch.where(far_new < -1e5, far, far_new)
    too_close = (far_new - near_new) < 0.1
    far_new = torch.where(too_close, far_new + 0.05, far_new)
    near_new = torch.where(too_close, near_new - 0.05, near_new)
    return near_new, far_new


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


def volume_render_rays(model, rays_o, rays_d, *, ray_tile: int = 0,
                       tile_max_candidates=None,
                       obj_bounding_radius: float = 1.0,
                       calc_normal: bool = False, use_view_dirs: bool = True,
                       white_bkgd: bool = False, near_bypass=None,
                       far_bypass=None, detailed_output: bool = True,
                       bounded_near_far: bool = True, perturb: bool = False,
                       generator=None, N_samples: int = 64,
                       N_importance: int = 64, N_upsample_iters: int = 4,
                       samples_output: bool = False,
                       random_color_direction: bool = False,
                       phi_s_base: float = 256.0,
                       reuse_upsample_sdf: bool = False, color_topk: int = 0,
                       root_anchored: bool = False, root_steps: int = 16,
                       root_secant: int = 3, root_n_fine: int = 48,
                       root_window: float = 0.0, root_win_frac: float = 0.5,
                       indicator_weight=None, **not_used_kwargs):
    """Render one chunk of (..., N, 3) rays (rays in tile order for
    ray_tile > 1); leading batch dims are flattened into the ray axis and
    restored on every output. rays_d need not be normalised. ray_tile > 1
    dividing the ray count binds tile-shared contexts; otherwise (ray_tile
    0, or the tiled binding unavailable) per-ray contexts after the
    closed-form bounded near/far. `generator` draws the perturbed
    up-sampling and the random colour directions. indicator_weight, w1
    already read to the host (the frame entry reads it once a frame), goes
    to the binding, which otherwise reads its own.

    Returns {"rgb" (..., 3), "depth_volume" (...), "mask_volume" (...)},
    with calc_normal "normals_volume" (..., 3), the weight-summed unit
    nablas. detailed_output (the default, as in the JAX package) adds the
    per-sample "implicit_surface", "radiance", "alpha", "cdf",
    "visibility_weights", "d_final" (and "implicit_nablas" with
    calc_normal), samples_output the distillation buffers "xyz", "dirs",
    "density", "colors" at the midpoints. color_topk applies only without
    detailed_output and random_color_direction: serving callers pass
    detailed_output=False."""
    prefix = rays_o.shape[:-1]
    rays_o = rays_o.reshape(-1, 3).to(torch.float32)
    rays_d = rays_d.reshape(-1, 3).to(torch.float32)
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    near, far = near_far_from_sphere(rays_o, rays_d, r=obj_bounding_radius)
    core = dict(calc_normal=calc_normal, use_view_dirs=use_view_dirs,
                white_bkgd=white_bkgd, detailed_output=detailed_output,
                perturb=perturb, generator=generator, N_samples=N_samples,
                N_importance=N_importance,
                N_upsample_iters=N_upsample_iters,
                samples_output=samples_output,
                random_color_direction=random_color_direction,
                phi_s_base=phi_s_base,
                reuse_upsample_sdf=reuse_upsample_sdf, color_topk=color_topk)

    def bypass(near, far):
        if near_bypass is not None:
            near = torch.full_like(near, near_bypass)
        if far_bypass is not None:
            far = torch.full_like(far, far_bypass)
        return near, far

    tb = None
    if ray_tile > 1 and hasattr(model, "bind_rays_tiled"):
        tb = model.bind_rays_tiled(rays_o, rays_d, near, far, tile=ray_tile,
                                   max_candidates=tile_max_candidates,
                                   w1=indicator_weight)
    if tb is not None:
        bound, near_t, far_t = tb
        if bounded_near_far:
            near, far = near_t, far_t
        near, far = bypass(near, far)
        d_all = None
        if root_anchored:
            if len(prefix) != 1 or calc_normal or random_color_direction:
                # a different sampling structure than the one asked for
                raise ValueError(
                    "root_anchored volume serving takes flat (R, 3) rays and "
                    "calc_normal=random_color_direction=False")
            d_all = _root_anchored(model, bound, rays_o, rays_d, near, far,
                                   root_steps, root_secant, root_n_fine,
                                   root_window, root_win_frac)
        return _unflat(_render_core(bound, rays_o, rays_d, near, far,
                                    d_all_override=d_all, **core), prefix)
    if root_anchored:
        # the per-ray path would render a different sampling structure
        raise ValueError(
            "root_anchored volume serving needs the tiled candidate binding: "
            f"ray_tile > 1 dividing the ray count (ray_tile={ray_tile}, "
            f"rays={rays_o.shape[0]})")

    bound = model
    if hasattr(model, "bind_rays"):
        if bounded_near_far:
            pre_ctx = model.make_ray_context(rays_o, rays_d, near, far,
                                             n_probes=16, for_bounds=True)
            if pre_ctx is not None:
                near, far = candidate_bounded_near_far(pre_ctx, rays_o,
                                                       rays_d, near, far)
            else:
                near, far = compute_bounded_near_far(model, rays_o, rays_d,
                                                     near, far)
        near, far = bypass(near, far)
        bound = model.bind_rays(rays_o, rays_d, near, far, n_probes=8,
                                w1=indicator_weight)
        bound = model if bound is None else bound
    else:
        # a model without a mesh (NeuS): the sphere bounds
        near, far = bypass(near, far)
    return _unflat(_render_core(bound, rays_o, rays_d, near, far, **core),
                   prefix)


def _unflat(ret, prefix):
    return {k: v.reshape(prefix + v.shape[1:]) for k, v in ret.items()}


@spanned("volume.root")
def _root_anchored(model, bound, rays_o, rays_d, near, far, root_steps,
                   root_secant, root_n_fine, root_window, root_win_frac):
    """Sorted depths concentrated around the first located crossing: a
    distance-proxy scan, the secant (fused with use_pallas) with the
    density re-bracket."""
    def scan_fn(pts):
        return bound.compute_distance(pts)[0][..., 0]

    def refine_fn(pts):
        return bound.forward_density_only(pts[:, None, :])[..., 0]

    secant_override = None
    if model.use_pallas:
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
    win = root_window if root_window else torch.clamp(6.0 / s_val, 0.02, 0.5)
    return root_anchored_depths(near, far, d_pred, mask, root_n_fine, win,
                                root_win_frac)


def _render_core(model, rays_o, rays_d, near, far, *, calc_normal=False,
                 use_view_dirs=True, white_bkgd, detailed_output=False,
                 perturb, generator, N_samples, N_importance,
                 N_upsample_iters, samples_output=False,
                 random_color_direction=False, phi_s_base,
                 reuse_upsample_sdf, color_topk=0, d_all_override=None):
    """Sampling + up-sampling + evaluation + compositing on a bound model
    with near/far resolved; d_all_override supplies sorted depths (the
    root-anchored structure) in place of coarse + up-sampling. The
    up-sampling runs without gradient, its densities from
    forward_density_only_nograd where the model has it; calc_normal
    evaluates the final sdf with nablas."""
    dev = rays_o.device

    def at(d):
        return rays_o[:, None, :] + d[..., None] * rays_d[:, None, :]

    sdf_up = None
    if d_all_override is not None:
        d_all = d_all_override.detach()
    else:
        with torch.no_grad():
            d_all, sdf_up = _upsample(model, at, near, far, perturb,
                                      generator, N_samples, N_importance,
                                      N_upsample_iters, phi_s_base)

    with span("volume.shade"):
        nablas = None
        if calc_normal:
            sdf, nablas = model.forward_with_nablas(at(d_all))
        elif reuse_upsample_sdf and sdf_up is not None:
            # inference only: the up-sampling densities carry no gradient
            sdf = sdf_up
        else:
            sdf = model.forward_density_only(at(d_all))

        d_mid = 0.5 * (d_all[..., 1:] + d_all[..., :-1])
        cdf, alpha = sdf_to_alpha(sdf, model.forward_s())
        w = alpha_to_w(alpha)
        view_dirs = rays_d if use_view_dirs else None
        use_topk = (color_topk and not detailed_output
                    and not random_color_direction
                    and color_topk < d_mid.shape[-1])
        if use_topk:
            # radiance only at the color_topk highest-visibility midpoints,
            # the selected mass renormalised to the ray's total
            order = torch.sort(-w.detach(), dim=-1,
                               stable=True).indices[..., :color_topk]
            d_sel = torch.gather(d_mid, -1, order)
            w_sel = torch.gather(w, -1, order)
            pts = at(d_sel)
            sdf_mid, rad = model.forward(pts, _dirs(view_dirs, pts))
            renorm = (torch.sum(w, -1, keepdim=True)
                      / (torch.sum(w_sel, -1, keepdim=True) + 1e-10))
            rgb = torch.sum(w_sel[..., None] * rad, dim=-2) * renorm
            dirs_mid = None
        else:
            pts = at(d_mid)
            if random_color_direction:
                # the view-independence trick of texture painting
                rnd = rand(pts.shape, generator, dev)
                dirs_mid = rnd / torch.linalg.vector_norm(rnd, dim=-1,
                                                          keepdim=True)
            else:
                dirs_mid = _dirs(view_dirs, pts)
            sdf_mid, rad = model.forward(pts, dirs_mid)
            rgb = torch.sum(w[..., None] * rad, dim=-2)
        depth = torch.sum(w / (torch.sum(w, -1, keepdim=True) + 1e-10) * d_mid,
                          dim=-1)
        acc = torch.sum(w, dim=-1)
        if white_bkgd:
            rgb = rgb + (1.0 - acc[..., None])
        ret = {"rgb": rgb, "depth_volume": depth, "mask_volume": acc}
        if calc_normal:
            normals = nablas / torch.clamp(
                torch.linalg.vector_norm(nablas, dim=-1, keepdim=True),
                min=1e-12)
            n_pts = min(w.shape[-1], normals.shape[-2])
            ret["normals_volume"] = torch.sum(
                normals[..., :n_pts, :] * w[..., :n_pts, None], dim=-2)
        if detailed_output:
            if calc_normal:
                ret["implicit_nablas"] = nablas
            ret.update(implicit_surface=sdf, radiance=rad, alpha=alpha,
                       cdf=cdf, visibility_weights=w, d_final=d_mid)
            if samples_output:
                # the per-sample buffers of distillation
                ret.update(xyz=pts, density=sdf_mid[..., None], colors=rad)
                if dirs_mid is not None:
                    ret["dirs"] = dirs_mid
        return ret


def _dirs(view_dirs, pts):
    return None if view_dirs is None else view_dirs[:, None, :].expand_as(pts)


def _upsample(model, at, near, far, perturb, generator, N_samples,
              N_importance, N_upsample_iters, phi_s_base):
    """N_samples coarse depths and N_upsample_iters rounds of NeuS
    hierarchical up-sampling -> (sorted depths, their densities)."""
    dens_fn = getattr(model, "forward_density_only_nograd",
                      model.forward_density_only)
    with span("volume.coarse"):
        _t = _linspace(N_samples, near.device)
        d = near * (1 - _t) + far * _t
        sdf = dens_fn(at(d))
    n_per = N_importance // N_upsample_iters
    with span("volume.upsample"):
        for i in range(N_upsample_iters):
            prev_sdf, next_sdf = sdf[..., :-1], sdf[..., 1:]
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
            sdf_fine = dens_fn(at(d_fine))
            d = torch.cat([d, d_fine], dim=-1)
            sdf = torch.cat([sdf, sdf_fine], dim=-1)
            d, order = torch.sort(d, dim=-1, stable=True)
            sdf = torch.gather(sdf, -1, order)
    return d, sdf


@torch.no_grad()
def volume_render(model, rays_o, rays_d, *, rayschunk: int = 0,
                  device="cuda", **kwargs):
    """Render (..., 3) rays in chunks of `rayschunk` rays (0: one chunk),
    the last chunk edge-padded (frame.render_chunks). Returns (rgb,
    depth, extras)."""
    render_device(model, device)
    shape = rays_o.shape[:-1]
    ret = render_chunks(
        lambda o, d: volume_render_rays(model, o, d, **kwargs),
        rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), rayschunk)
    ret = {k: v.reshape(shape + v.shape[1:]) for k, v in ret.items()}
    return ret["rgb"], ret["depth_volume"], ret


@torch.no_grad()
@spanned("render.frame")
def render_image(model, c2w, K, H: int, W: int, *, block=(8, 16),
                 replicas=None, rayschunk: int = 0,
                 force_shard_map: bool = False, rays_output: bool = False,
                 device="cuda", **kwargs):
    """One frame on the frame layer (frame.render_frame): camera rays in
    block_h x block_w pixel-block order (tile contexts need compact ray
    bundles; (1, W) is raster order) -> chunks split over `replicas`,
    volume_render_rays on each -> raster order. c2w (4, 4), K (3|4, 3|4);
    kwargs go to volume_render_rays. Returns (rgb (H, W, 3), depth
    (H, W), extras), with rays_output the camera rays "rays_o" and
    "rays_d" (H, W, 3) among the extras."""
    def render(rep, o, d, w1):
        return volume_render_rays(rep, o, d, indicator_weight=w1, **kwargs)

    ret = render_frame(model, c2w, K, H, W, block, device, replicas,
                       rayschunk, kwargs.get("ray_tile", 0) or 0, render,
                       rays_output=rays_output,
                       force_shard_map=force_shard_map)
    return ret["rgb"], ret["depth_volume"], ret


class SingleRenderer:
    """The volume render as a callable on one model (the trainer's
    validation, ray batches that are not frames): (rays_o, rays_d, **render
    kwargs) -> (rgb, depth, extras). The builders' training-only kwargs
    are dropped; detailed_output defaults to False here (a serving call:
    color_topk applies, no per-sample outputs)."""

    _TRAINING_ONLY = ("batched", "N_nograd_samples")

    def __init__(self, model):
        self.model = model

    def __call__(self, rays_o, rays_d, **kwargs):
        for k in self._TRAINING_ONLY:
            kwargs.pop(k, None)
        kwargs.setdefault("detailed_output", False)
        return volume_render(self.model, rays_o, rays_d,
                             device=self.model.device, **kwargs)
