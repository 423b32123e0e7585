"""Plain NeuS volume rendering (NeuS, NeurIPS 2021): the reference sampling
structure of the quality render, N_samples uniform depths, N_upsample_iters
rounds of hierarchical up-sampling from the sdf with a doubling logistic
sharpness, then alpha from the logistic CDF of the sdf at the sorted
depths and colour at every midpoint.

`field` answers density(x, ids) and full(x, ids, view) for rays that carry
candidate ids (ids=None for a field without a mesh). Imports nothing of
the program.
"""
from __future__ import annotations

import torch


def sphere_near_far(o, d, r: float):
    mid = -torch.sum(o * d, -1, keepdim=True)
    return torch.clamp(mid - r, min=0.0), torch.clamp(mid + r, min=r)


def candidate_near_far(o, d, near, far, cand_pts, thresh: float = 0.1):
    """near/far shrunk to where the ray passes within `thresh` of one of
    its candidate vertices (R, C, 3), widened by 0.05 each way when under
    0.1 apart; rays near no candidate keep their bounds."""
    ov = cand_pts - o[:, None, :]
    t_c = torch.sum(ov * d[:, None, :], -1)
    s2 = thresh * thresh - (torch.sum(ov * ov, -1) - t_c * t_c)
    cov = s2 > 0
    s = torch.sqrt(torch.clamp(s2, min=0.0))
    lo = torch.where(cov, t_c - s, torch.full_like(s, 1e10))
    hi = torch.where(cov, t_c + s, torch.full_like(s, -1e10))
    hit = torch.any(cov, -1, keepdim=True)
    n2 = torch.clamp(torch.amin(lo, -1, keepdim=True), near, far)
    f2 = torch.clamp(torch.amax(hi, -1, keepdim=True), near, far)
    n2 = torch.where(hit, n2, near)
    f2 = torch.where(hit, f2, far)
    close = (f2 - n2) < 0.1
    return (torch.where(close, n2 - 0.05, n2),
            torch.where(close, f2 + 0.05, f2))


def alpha_from_sdf(sdf, s):
    cdf = torch.sigmoid(sdf * s)
    return torch.clamp((cdf[..., :-1] - cdf[..., 1:]) / (cdf[..., :-1]
                                                         + 1e-10), min=0.0)


def visibility(alpha):
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha + 1e-10], -1), -1)
    return alpha * trans[..., :-1]


def sample_pdf(bins, weights, n: int, u=None):
    """Inverse-CDF sampling of n depths per ray from piecewise-constant
    weights over bins; u (R, n) uniforms, or evenly spaced probes."""
    w = weights + 1e-5
    cdf = torch.cumsum(w / torch.sum(w, -1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=bins.device).expand(
            cdf.shape[0], n)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous())
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0, b1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    den = torch.where(c1 - c0 < 1e-5, torch.ones_like(c1), c1 - c0)
    return b0 + (u - c0) / den * (b1 - b0)


def upsample(density, o, d, near, far, n_samples, n_importance, n_iters,
             phi_s_base=256.0, uniforms=None):
    """Sorted depths (R, n_samples + n_importance) and their sdf.
    uniforms: a list of n_iters (R, n_importance / n_iters) draws for the
    perturbed (training) placement, else evenly spaced probes."""
    def at(z):
        return o[:, None, :] + z[..., None] * d[:, None, :]

    t = torch.linspace(0.0, 1.0, n_samples, device=o.device)
    z = near * (1 - t) + far * t
    sdf = density(at(z))
    per = n_importance // n_iters
    for i in range(n_iters):
        dz = z[..., 1:] - z[..., :-1]
        mid = 0.5 * (sdf[..., :-1] + sdf[..., 1:])
        slope = (sdf[..., 1:] - sdf[..., :-1]) / (dz + 1e-5)
        prev = torch.cat([torch.zeros_like(slope[..., :1]), slope[..., :-1]],
                         -1)
        slope = torch.clamp(torch.minimum(prev, slope), -10.0, 0.0)
        s_i = phi_s_base * 2 ** i
        c_prev = torch.sigmoid((mid - slope * dz * 0.5) * s_i)
        c_next = torch.sigmoid((mid + slope * dz * 0.5) * s_i)
        alpha = (c_prev - c_next + 1e-5) / (c_prev + 1e-5)
        zf = sample_pdf(z, visibility(alpha), per,
                        None if uniforms is None else uniforms[i])
        z, order = torch.sort(torch.cat([z, zf], -1), dim=-1, stable=True)
        sdf = torch.gather(torch.cat([sdf, density(at(zf))], -1), -1, order)
    return z, sdf


def composite(w, rad, z_mid):
    rgb = torch.sum(w[..., None] * rad, -2)
    depth = torch.sum(w / (torch.sum(w, -1, keepdim=True) + 1e-10) * z_mid,
                      -1)
    return rgb, depth, torch.sum(w, -1)


@torch.no_grad()
def render_rays(field, o, d, ids, r: dict):
    """The quality render of rays (R, 3) bound to candidate ids (R, C):
    -> rgb (R, 3), depth (R,), opacity (R,). r holds the render's
    N_samples, N_importance, N_upsample_iters, obj_bounding_radius."""
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    near, far = sphere_near_far(o, d, r["obj_bounding_radius"])
    near, far = candidate_near_far(o, d, near, far, field.verts[ids])
    z, sdf = upsample(lambda x: field.density(x, ids), o, d, near, far,
                      r["N_samples"], r["N_importance"],
                      r["N_upsample_iters"])
    w = visibility(alpha_from_sdf(sdf, field.s()))
    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
    x = o[:, None, :] + z_mid[..., None] * d[:, None, :]
    _, _, rad = field.full(x, ids, d[:, None, :].expand_as(x))
    return composite(w, rad, z_mid)
