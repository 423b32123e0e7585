"""Surface rendering (counterpart of neumesh_tpu/render/ray_casting.py):
DVR-style root finding and sphere tracing, composed into surface_render
(tile-shared or per-ray candidate bindings) and the frame entry
render_surface_image. Sign convention: (+) outside, (-) inside."""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device, set_fp32_precision
from ..models.neumesh.model import candidate_bounded_near_far
from ..ops.kernels import secant_pred
from ..ops.rays import block_order_indices, get_rays, near_far_from_sphere
from ..utils.trace import count, count_device, span, spanned


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
                                method: str = "secant",
                                N_secant_steps: int = 8,
                                fill_inf: bool = True, refine_query_fn=None,
                                secant_override=None,
                                rebracket: bool = True):
    """N_steps sign-change scan of surface_query_fn over [near, far] (R,),
    then secant refinement on refine_query_fn (the true density) when
    given. With secant_override the refinement is one fused launch and a
    re-bracket at the half-step-widened scan endpoints is folded into it.
    Any other method than "secant" skips the refinement: d_pred = 1 at
    every hit, as the JAX package does. Returns (d_pred (R,), pt_pred (R, 3), mask, mask_sign_change)."""
    R = rays_o.shape[0]
    dev = rays_o.device
    with span("surface.scan"):
        t = torch.linspace(0.0, 1.0, N_steps, device=dev)
        d_proposal = near[..., None] * (1 - t) + far[..., None] * t
        p_proposal = (rays_o[:, None, :]
                      + d_proposal[..., None] * rays_d[:, None, :])
        val = surface_query_fn(p_proposal) - logit_tau         # (R, N_steps)

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
    fold = do_rebracket and method == "secant" and secant_override is not None
    step = (far - near) / max(N_steps - 1, 1)
    with span("surface.secant"):
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

        if method != "secant":
            d_pred = torch.ones_like(near)
        else:
            count("secant.rays_refined", R)
            count_device("secant.rays_bracketed", mask)
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
                d_pred = run_secant_method(f_low, f_high, d_low, d_high,
                                           rays_o, rays_d, secant_fn,
                                           N_secant_steps, logit_tau)

        d_out, pt_pred = _hit_points(rays_o, rays_d, d_pred, mask,
                                     mask_0_not_occupied, far, fill_inf)
    return d_out, pt_pred, mask, mask_sign_change


def _hit_points(rays_o, rays_d, d_pred, mask, val0_pos, far, fill_inf):
    """(depth, point) per ray: misses get inf (fill_inf) or far and the
    point (1, 1, 1); rays starting inside the surface get depth 0."""
    pt_pred = torch.where(mask[..., None],
                          rays_o + d_pred[..., None] * rays_d,
                          torch.ones_like(rays_o))
    miss = torch.full_like(far, float("inf")) if fill_inf else far
    d_out = torch.where(mask, d_pred, miss)
    d_out = torch.where(val0_pos, d_out, torch.zeros_like(d_out))
    return d_out, pt_pred


def sphere_tracing_surface_points(surface_query_fn, rays_o, rays_d,
                                  near=0.0, far=6.0, N_iters: int = 20):
    """Sphere tracing: every ray steps by the queried value N_iters times
    and leaves the mask once its depth passes far or goes below 0.
    Returns (d_pred (R,), pts (R, 3), mask (R,))."""
    shape = rays_o.shape[:-1]
    d_preds = torch.broadcast_to(
        torch.as_tensor(near, dtype=torch.float32, device=rays_o.device),
        shape).clone()
    mask = torch.ones(shape, dtype=torch.bool, device=rays_o.device)
    for _ in range(N_iters):
        pts = rays_o + rays_d * d_preds[..., None]
        d_preds = torch.where(mask, d_preds + surface_query_fn(pts), d_preds)
        mask = mask & (d_preds <= far) & (d_preds >= 0)
    return d_preds, rays_o + rays_d * d_preds[..., None], mask


@torch.no_grad()
def surface_render(model, rays_o, rays_d, *, calc_normal: bool = True,
                   ray_casting_algo: str = "root_finding",
                   ray_casting_cfgs=None, ray_tile: int = 0,
                   scan_mode: str = "density", tile_max_candidates=None,
                   shade_composite: int = 0, shade_topk: int = 0,
                   shade_win_frac: float = 0.5, shade_window: float = 0.0,
                   device="cuda", **not_used_kwargs):
    """Cast (..., 3) rays to the zero level set, then shade once per ray.

    ray_tile > 1 dividing the ray count binds tile-shared candidate
    contexts of `ray_tile` consecutive rays; otherwise every ray binds its
    own context after the closed-form mesh-bounded near/far (a model
    without a candidate grid is queried per sample). With use_pallas the
    secant runs as one fused launch (secant_refine, one ray per context on
    the per-ray binding). scan_mode="distance" scans the interpolated
    mesh distance and refines on the density (scan + secant, or one
    surface_locate launch with use_fused_locate and use_pallas). The hit
    is shaded by one (sdf, rgb, nablas) query, or with shade_composite >
    0 by the volume renderer's root-anchored tail (density at
    shade_composite depths around the root, colour at the shade_topk
    highest-visibility midpoints) with normals from one forward_with_nablas
    query. Keywords of the volume renderer that do not apply here are
    accepted and ignored. Returns (rgb (..., 3), depth (...),
    {"implicit_nablas", "mask_surface", "normals_surface" (calc_normal)})."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model on {model.device}, device={dev}")
    if dev.type == "cuda":
        set_fp32_precision()
    cfgs = dict(ray_casting_cfgs or {})
    shape = rays_o.shape[:-1]
    rays_o = rays_o.reshape(-1, 3).to(torch.float32)
    rays_d = rays_d.reshape(-1, 3).to(torch.float32)
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    R = rays_o.shape[0]
    near, far = near_far_from_sphere(rays_o, rays_d, keepdim=False)
    bound = model
    if ray_tile > 1 and R % ray_tile == 0:
        tb = model.bind_rays_tiled(rays_o, rays_d, near[:, None],
                                   far[:, None], tile=ray_tile,
                                   max_candidates=tile_max_candidates)
        if tb is not None:
            bound, near_b, far_b = tb
            near, far = near_b[:, 0], far_b[:, 0]
    else:
        pre_ctx = model.make_ray_context(rays_o, rays_d, near[:, None],
                                         far[:, None], n_probes=16,
                                         for_bounds=True)
        if pre_ctx is not None:
            near_b, far_b = candidate_bounded_near_far(
                pre_ctx, rays_o, rays_d, near[:, None], far[:, None])
            near, far = near_b[:, 0], far_b[:, 0]
            bound = model.bind_rays(rays_o, rays_d, near[:, None],
                                    far[:, None])
    for key, v in (("near", near), ("far", far)):
        cfgs[key] = torch.broadcast_to(torch.as_tensor(
            cfgs.get(key, v), dtype=torch.float32, device=rays_o.device),
            (R,))

    def query_fn(pts):
        if pts.dim() == 2:      # (R, 3) secant / tracing queries
            return bound.forward_density_only(pts[:, None, :])[..., 0]
        return bound.forward_density_only(pts)

    scan_fn, refine_fn = query_fn, None
    if scan_mode == "distance":
        def scan_fn(pts):
            return bound.compute_distance(pts)[0][..., 0]
        refine_fn = query_fn

    secant_override = None
    if model.use_pallas and hasattr(bound, "fused_secant"):
        def secant_override(f_low, f_high, d_low, d_high, n, tau,
                            d_low_w=None, d_high_w=None):
            return bound.fused_secant(rays_o, rays_d, d_low, d_high, f_low,
                                      f_high, n_iters=n, logit_tau=tau,
                                      d_low_w=d_low_w, d_high_w=d_high_w)

    if (ray_casting_algo == "root_finding" and scan_mode == "distance"
            and model.use_pallas and model.use_fused_locate
            and hasattr(bound, "fused_locate")):
        with span("surface.secant"):
            d_pred, mask, _, val0_pos = bound.fused_locate(
                rays_o, rays_d, cfgs["near"], cfgs["far"],
                n_steps=cfgs.get("N_steps", 24),
                n_secant=cfgs.get("N_secant_steps", 6),
                logit_tau=cfgs.get("logit_tau", 0.0))
            count("secant.rays_refined", R)
            count_device("secant.rays_bracketed", mask)
            d_pred, pt_pred = _hit_points(rays_o, rays_d, d_pred, mask,
                                          val0_pos, cfgs["far"],
                                          cfgs.get("fill_inf", True))
    elif ray_casting_algo == "root_finding":
        # an unbound model re-brackets whatever its secant_rebracket says,
        # as the JAX package does
        cfgs.setdefault("rebracket", getattr(getattr(bound, "model", None),
                                             "secant_rebracket", True))
        d_pred, pt_pred, mask, _ = root_finding_surface_points(
            scan_fn, rays_o, rays_d, refine_query_fn=refine_fn,
            secant_override=secant_override, **cfgs)
    elif ray_casting_algo == "sphere_tracing":
        d_pred, pt_pred, mask = sphere_tracing_surface_points(
            query_fn, rays_o, rays_d,
            **{k: v for k, v in cfgs.items()
               if k in ("near", "far", "N_iters")})
    else:
        raise NotImplementedError(ray_casting_algo)

    with span("surface.shade"):
        if shade_composite > 0:
            from .volume import _render_core, root_anchored_depths
            win = (shade_window if shade_window
                   else torch.clamp(6.0 / bound.forward_s(), 0.02, 0.5))
            d_shade = root_anchored_depths(near[:, None], far[:, None],
                                           d_pred, mask, shade_composite,
                                           win, shade_win_frac)
            color = _render_core(
                bound, rays_o, rays_d, near[:, None], far[:, None],
                white_bkgd=False, perturb=False, generator=None,
                N_samples=shade_composite, N_importance=0,
                N_upsample_iters=1,
                phi_s_base=256.0, reuse_upsample_sdf=False,
                color_topk=shade_topk, detailed_output=False,
                d_all_override=d_shade)["rgb"]
            if calc_normal:
                _, nablas = bound.forward_with_nablas(pt_pred[:, None, :])
            else:
                nablas = torch.zeros_like(pt_pred)[:, None, :]
        elif hasattr(bound, "forward_full"):
            _, color, nablas = bound.forward_full(pt_pred[:, None, :],
                                                  rays_d[:, None, :])
            color = color[:, 0]
        else:
            _, color = bound.forward(pt_pred[:, None, :],
                                     rays_d[:, None, :])
            _, nablas = bound.forward_with_nablas(pt_pred[:, None, :])
            color = color[:, 0]
        color = torch.where(mask[:, None], color, torch.zeros_like(color))
        nablas = nablas[:, 0]

        extras = {"implicit_nablas": nablas, "mask_surface": mask}
        if calc_normal:
            normals = nablas / torch.clamp(
                torch.linalg.vector_norm(nablas, dim=-1, keepdim=True),
                min=1e-12)
            extras["normals_surface"] = torch.where(mask[:, None], normals,
                                                    torch.zeros_like(normals))
    return (color.reshape(shape + (3,)), d_pred.reshape(shape),
            {k: v.reshape(shape + v.shape[1:]) for k, v in extras.items()})


@torch.no_grad()
@spanned("render.frame")
def render_surface_image(model, c2w, K, H: int, W: int, *,
                         ray_tile: int = 128, rayschunk: int = 0,
                         N_steps: int = 128, N_secant_steps: int = 8,
                         scan_mode: str = "density", device="cuda",
                         **kwargs):
    """One surface-rendered frame (the render CLI's surface mode): camera
    rays -> pixel blocks of ray_tile rays (block height int(sqrt(tile //
    2)), halved until the block divides the frame) -> chunks of a
    tile-multiple size, the last edge-padded -> surface_render with
    fill_inf=False and normals -> raster order. c2w (4, 4), K (3|4, 3|4);
    kwargs go to surface_render. Returns (rgb (H, W, 3), depth (H, W),
    {"normals_surface" (H, W, 3), "mask_surface" (H, W)})."""
    dev = resolve_device(device)
    bh = max(1, int(np.sqrt(ray_tile // 2)))
    bw = ray_tile // bh
    while bh > 1 and (H % bh or W % bw):
        bh //= 2
        bw = ray_tile // bh
    if ray_tile <= 1 or H % bh or W % bw:
        raise ValueError(f"ray_tile={ray_tile}: no pixel block of that many "
                         f"rays divides {H}x{W}")
    with span("render.rays"):
        # blocks: c2w, K, perm and inv are copies from pageable host memory
        count("host_read", 4)
        c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
        K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
        rays_o, rays_d = get_rays(c2w, K, H, W)
        perm, inv = block_order_indices(H, W, bh, bw)
        perm = torch.as_tensor(perm, device=dev)
        inv = torch.as_tensor(inv, device=dev)
        ro, rd = rays_o[perm], rays_d[perm]
        n = H * W
        chunk = -(-(rayschunk or n) // ray_tile) * ray_tile
        pad = (-n) % chunk
        if pad:
            ro = torch.cat([ro, ro[-1:].expand(pad, 3)], 0)
            rd = torch.cat([rd, rd[-1:].expand(pad, 3)], 0)
    cfgs = {"N_steps": N_steps, "N_secant_steps": N_secant_steps,
            "fill_inf": False}
    outs = [surface_render(model, ro[i:i + chunk], rd[i:i + chunk],
                           calc_normal=True, ray_tile=ray_tile,
                           scan_mode=scan_mode, ray_casting_cfgs=cfgs,
                           device=device, **kwargs)
            for i in range(0, n + pad, chunk)]

    def frame(parts):
        return torch.cat(parts, 0)[:n][inv].reshape(H, W, *parts[0].shape[1:])

    with span("render.assemble"):
        rgb = frame([o[0] for o in outs])
        depth = frame([o[1] for o in outs])
        extras = {k: frame([o[2][k] for o in outs])
                  for k in ("normals_surface", "mask_surface")}
    return rgb, depth, extras
