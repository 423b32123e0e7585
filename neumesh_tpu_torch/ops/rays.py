"""Ray generation and along-ray sampling (counterpart of
neumesh_tpu/ops/rays.py)."""
from __future__ import annotations

import numpy as np
import torch


def lift(x, y, z, intrinsics):
    """Pixel coords -> camera-space points, with skew support."""
    fx, fy = intrinsics[..., 0, 0], intrinsics[..., 1, 1]
    cx, cy = intrinsics[..., 0, 2], intrinsics[..., 1, 2]
    sk = intrinsics[..., 0, 1]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack((x_lift, y_lift, z, torch.ones_like(z)), dim=-1)


def get_rays(c2w, intrinsics, H: int, W: int):
    """All H*W pixel rays of one camera in row-major order.
    c2w (4, 4), intrinsics (3|4, 3|4) -> rays_o, rays_d (H*W, 3); rays_d
    normalised in camera space, then rotated to world."""
    idx = torch.arange(H * W, device=c2w.device)
    i = (idx % W).to(torch.float32)
    j = (idx // W).to(torch.float32)
    cam = lift(i, j, torch.ones_like(i), intrinsics)
    d = cam[..., :3]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    rays_d = d @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand_as(rays_d)
    return rays_o.contiguous(), rays_d


def near_far_from_sphere(rays_o, rays_d, r: float = 1.0,
                         keepdim: bool = True):
    """near = max(mid - r, 0), far = max(mid + r, r), mid = -<o, d>."""
    mid = -torch.sum(rays_o * rays_d, dim=-1, keepdim=keepdim)
    return torch.clamp(mid - r, min=0.0), torch.clamp(mid + r, min=r)


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
            u = torch.rand(shape, generator=generator,
                           device=cdf.device)
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
