"""Ray generation and along-ray sampling (counterpart of
neumesh_tpu/ops/rays.py)."""
from __future__ import annotations

import math

import numpy as np
import torch


def lift(x, y, z, intrinsics):
    """Pixel coords (..., N) -> camera-space points (..., N, 4), with skew
    support; intrinsics (..., 3|4, 3|4)."""
    fx, fy = intrinsics[..., 0, 0, None], intrinsics[..., 1, 1, None]
    cx, cy = intrinsics[..., 0, 2, None], intrinsics[..., 1, 2, None]
    sk = intrinsics[..., 0, 1, None]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack((x_lift, y_lift, z, torch.ones_like(z)), dim=-1)


def pixel_to_rays(i, j, c2w, intrinsics):
    """Rays through pixel centres (i = x / column, j = y / row, (..., N)):
    c2w (..., 4, 4), intrinsics (..., 3|4, 3|4) -> rays_o, rays_d
    (..., N, 3); rays_d normalised in camera space, then rotated."""
    cam = lift(i, j, torch.ones_like(i), intrinsics)
    d = cam[..., :3]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    rays_d = torch.matmul(d, c2w[..., :3, :3].transpose(-1, -2))
    rays_o = c2w[..., None, :3, 3].expand_as(rays_d).contiguous()
    return rays_o, rays_d


def get_rays(c2w, intrinsics, H: int, W: int, N_rays: int = -1,
             generator=None, select_inds=None):
    """Pixel rays of a camera, or of a batch of cameras: c2w (..., 4, 4),
    intrinsics (..., 3|4, 3|4) -> rays_o, rays_d (..., N, 3); rays_d
    normalised in camera space, then rotated to world.

    Without N_rays or select_inds: all H*W pixels in row-major order,
    returned as (rays_o, rays_d). With N_rays > 0: min(N_rays, H*W)
    pixels by independently uniform row and column indices drawn from
    `generator` (shared by the cameras of a batch; a
    parallel.ShardedGenerator draws them all and keeps this rank's slice),
    or the given select_inds (N,); returned as (rays_o, rays_d,
    select_inds (..., N))."""
    prefix = c2w.shape[:-2]
    dev = c2w.device
    sampled = N_rays > 0 or select_inds is not None
    if select_inds is None:
        if N_rays > 0:
            n = min(N_rays, H * W)
            if isinstance(generator, torch.Generator) or generator is None:
                hs = torch.randint(0, H, (n,), generator=generator,
                                   device=dev)
                ws = torch.randint(0, W, (n,), generator=generator,
                                   device=dev)
            else:
                hs = generator.rays(H, n, dev)
                ws = generator.rays(W, n, dev)
            select_inds = hs * W + ws
        else:
            select_inds = torch.arange(H * W, device=dev)
    select_inds = torch.as_tensor(select_inds, device=dev).expand(
        prefix + select_inds.shape[-1:])
    i = (select_inds % W).to(torch.float32)
    j = (select_inds // W).to(torch.float32)
    rays_o, rays_d = pixel_to_rays(i, j, c2w, intrinsics)
    if sampled:
        return rays_o, rays_d, select_inds
    return rays_o, rays_d


def rand(shape, generator, device) -> torch.Tensor:
    """torch.rand(shape) from `generator`; a parallel.ShardedGenerator
    draws the global (image x ray) rows and keeps this rank's (shape[0]
    flattens its images' rays)."""
    if isinstance(generator, torch.Generator) or generator is None:
        return torch.rand(shape, generator=generator, device=device)
    return generator.rand(shape, device)


def near_far_from_sphere(rays_o, rays_d, r: float = 1.0,
                         keepdim: bool = True):
    """near = max(mid - r, 0), far = max(mid + r, r), mid = -<o, d>."""
    mid = -torch.sum(rays_o * rays_d, dim=-1, keepdim=keepdim)
    return torch.clamp(mid - r, min=0.0), torch.clamp(mid + r, min=r)


def get_sphere_intersection(rays_o, rays_d, r: float = 1.0):
    """Exact ray-sphere intersection: (near, far, mask_intersect), near
    and far (..., 1) clamped at 0 and 0 where the ray misses."""
    rayso_norm_square = torch.sum(rays_o ** 2, dim=-1, keepdim=True)
    ray_cam_dot = torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    under_sqrt = ray_cam_dot ** 2 + r ** 2 - rayso_norm_square
    mask_intersect = under_sqrt > 0
    sqrt = torch.sqrt(torch.clamp(under_sqrt, min=0.0))
    zero = torch.zeros_like(sqrt)
    near = torch.where(mask_intersect, -sqrt - ray_cam_dot, zero)
    far = torch.where(mask_intersect, sqrt - ray_cam_dot, zero)
    return (torch.clamp(near, min=0.0), torch.clamp(far, min=0.0),
            mask_intersect)


def sample_pdf(bins, weights, N_importance: int, det: bool = False,
               eps: float = 1e-5, generator=None, u=None):
    """Inverse-CDF hierarchical sampling. bins (..., n), weights
    (..., n - 1) -> (..., N_importance). det=True probes linspace(0, 1);
    otherwise uniforms from `generator` (or the given `u`)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    shape = cdf.shape[:-1] + (N_importance,)
    if u is None:
        if det:
            u = torch.linspace(0.0, 1.0, N_importance,
                               device=cdf.device).expand(shape)
        else:
            u = rand(shape, generator, cdf.device)
    # inds = #{i : cdf[i] < u}, the rank count of the reference
    inds = torch.sum((cdf[..., None, :] < u[..., :, None]).to(torch.int64),
                     dim=-1)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sample_cdf(bins, cdf, N_importance: int, det: bool = False,
               eps: float = 1e-5, generator=None, u=None):
    """Inverse sampling from a precomputed cdf: bins (..., n) sorted,
    cdf (..., n - 1) in [0, 1] (a leading zero is prepended) ->
    (..., N_importance), by sample_pdf's rank count and interpolation."""
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    shape = cdf.shape[:-1] + (N_importance,)
    if u is None:
        if det:
            u = torch.linspace(0.0, 1.0, N_importance,
                               device=cdf.device).expand(shape)
        else:
            u = rand(shape, generator, cdf.device)
    inds = torch.sum((cdf[..., None, :] < u[..., :, None]).to(torch.int64),
                     dim=-1)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def lin2img(x, H: int, W: int, batched: bool = False, B=None):
    """(..., H*W, C) flat pixels -> channels-first (C, H, W), or
    (B, C, H, W) when batched (B splits the leading rows if given)."""
    n, c = x.shape[-2], x.shape[-1]
    if not (n == H * W or (batched and B is not None)):
        raise ValueError(f"lin2img: {n} pixels is not {H}x{W}")
    if batched:
        if B is None:
            B = x.shape[0]
        else:
            x = x.reshape(B, n // B, c)
        return x.permute(0, 2, 1).reshape(B, c, H, W)
    return x.permute(1, 0).reshape(c, H, W)


def block_order_indices(H: int, W: int, block_h: int = 8,
                        block_w: int = 16):
    """(perm, inv_perm) numpy permutations grouping flattened pixels into
    block_h x block_w image tiles (row-major inside a block, blocks in
    row-major order)."""
    assert H % block_h == 0 and W % block_w == 0, (H, W, block_h, block_w)
    idx = np.arange(H * W).reshape(H, W)
    blocks = idx.reshape(H // block_h, block_h, W // block_w, block_w)
    perm = blocks.transpose(0, 2, 1, 3).reshape(-1)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(H * W)
    return perm, inv


def pixel_block(H: int, W: int, tile: int):
    """The pixel block of `tile` (> 1) rays that tiles an H x W frame:
    block height isqrt(tile // 2), halved until the block divides the
    frame -> (block_h, block_w), or None where no block does."""
    bh = max(1, math.isqrt(tile // 2))
    bw = tile // bh
    while bh > 1 and (H % bh or W % bw):
        bh //= 2
        bw = tile // bh
    return None if H % bh or W % bw else (bh, bw)


def block_order(H: int, W: int, block_h: int = 8, block_w: int = 16,
                device=None) -> torch.Tensor:
    """block_order_indices' perm as a tensor built on `device`: the pixel
    indices of an H x W frame in block_h x block_w block order."""
    if H % block_h or W % block_w:
        raise ValueError(f"{block_h}x{block_w} blocks do not tile {H}x{W}")
    return torch.arange(H * W, device=device).view(
        H // block_h, block_h, W // block_w, block_w).permute(
        0, 2, 1, 3).reshape(-1)


def raster_order(x: torch.Tensor, H: int, W: int, block_h: int = 8,
                 block_w: int = 16) -> torch.Tensor:
    """(H*W, ...) rows in block_order -> (H, W, ...) in raster order: the
    gather by block_order_indices' inv, as a view and one copy."""
    rest = x.shape[1:]
    return x.reshape(H // block_h, W // block_w, block_h, block_w,
                     *rest).transpose(1, 2).reshape(H, W, *rest)
