"""Plain surface rendering by root finding (the DVR-style scan and secant
of NeuMesh's surface mode): a uniform scan of the interpolated mesh
distance finds the first sign change, the bracket is re-tried on the
density at endpoints widened by half a scan step, secant iterations on
the density refine the root, and the hit is shaded once with its colour
and normal. Imports nothing of the program.
"""
from __future__ import annotations

import torch

from .volume import candidate_near_far, sphere_near_far


def secant_pred(f_low, f_high, d_low, d_high):
    den = f_high - f_low
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12),
                      den)
    return -f_low * (d_high - d_low) / den + d_low


@torch.no_grad()
def render_rays(field, o, d, ids, r: dict):
    """Rays (R, 3) bound to candidate ids (R, C) -> rgb (R, 3), depth (R,),
    normals (R, 3), hit mask (R,). r holds N_steps, N_secant_steps and
    obj_bounding_radius; misses take depth far, black and a zero normal,
    rays starting inside the surface depth 0."""
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    near, far = sphere_near_far(o, d, r["obj_bounding_radius"])
    near, far = candidate_near_far(o, d, near, far, field.verts[ids])
    near, far = near[:, 0], far[:, 0]
    n = r["N_steps"]
    t = torch.linspace(0.0, 1.0, n, device=o.device)
    z = near[:, None] * (1 - t) + far[:, None] * t
    val = field.nearest_distance(o[:, None, :] + z[..., None]
                                 * d[:, None, :], ids)
    start_outside = val[:, 0] > 0
    crossing = val[:, :-1] * val[:, 1:] < 0
    first = torch.argmax(crossing.to(torch.int8), -1)
    hit = torch.any(crossing, -1)
    i0 = first[:, None]
    f_high = torch.gather(val, -1, i0)[:, 0]
    d_high = torch.gather(z, -1, i0)[:, 0]
    f_low = torch.gather(val, -1, i0 + 1)[:, 0]
    d_low = torch.gather(z, -1, i0 + 1)[:, 0]
    mask = hit & (f_high > 0) & start_outside

    def density(depth):
        return field.density((o + depth[:, None] * d)[:, None, :], ids)[:, 0]

    step = (far - near) / max(n - 1, 1)
    d_hw = torch.maximum(d_high - 0.5 * step, near)
    d_lw = torch.minimum(d_low + 0.5 * step, far)
    f_hw, f_lw = density(d_hw), density(d_lw)
    ok = (f_hw > 0) & (f_lw < 0)
    f_high = torch.where(ok, f_hw, f_high)
    f_low = torch.where(ok, f_lw, f_low)
    d_high = torch.where(ok, d_hw, d_high)
    d_low = torch.where(ok, d_lw, d_low)
    d_pred = secant_pred(f_low, f_high, d_low, d_high)
    for _ in range(r["N_secant_steps"]):
        f_mid = density(d_pred)
        low = f_mid < 0
        d_low = torch.where(low, d_pred, d_low)
        f_low = torch.where(low, f_mid, f_low)
        d_high = torch.where(low, d_high, d_pred)
        f_high = torch.where(low, f_high, f_mid)
        d_pred = secant_pred(f_low, f_high, d_low, d_high)
    pt = torch.where(mask[:, None], o + d_pred[:, None] * d,
                     torch.ones_like(o))
    _, nabla, rgb = field.full(pt[:, None, :], ids, d[:, None, :])
    nabla, rgb = nabla[:, 0], rgb[:, 0]
    normal = nabla / torch.clamp(torch.linalg.vector_norm(
        nabla, dim=-1, keepdim=True), min=1e-12)
    zero = torch.zeros_like(rgb)
    depth = torch.where(mask, d_pred, far)
    depth = torch.where(start_outside, depth, torch.zeros_like(depth))
    return (torch.where(mask[:, None], rgb, zero), depth,
            torch.where(mask[:, None], normal, zero), mask)
