"""Mesh ray casting (counterpart of neumesh_tpu/mesh/raycast.py). Used to
find the vertices that paint rays touch.

backend="native" (the default, as in the JAX package): the C++ BVH of the
host library (cpp/native.py). backend="device": a chunked Moller-Trumbore
test of every ray against every triangle in float64 on a torch device,
with the epsilons of the JAX package's numpy caster, keeping the nearest
hit. Both return the same (t_hit, prim) on rays without ties.
"""
from __future__ import annotations

import numpy as np
import torch

from .triangle_mesh import TriangleMesh

INVALID_ID = -1


def cast_rays(mesh: TriangleMesh, rays_o, rays_d, backend: str = "native",
              device="cuda", pairs_per_chunk: int = 1 << 24):
    """(t_hit (N,), primitive_ids (N,)) as float64 / int64 numpy arrays;
    inf / -1 on a miss: a ray's nearest hit. backend "native" (the BVH on
    the host) or "device" (on `device`; at equal t the lower triangle id,
    each chunk testing about pairs_per_chunk ray-triangle pairs)."""
    if backend == "native":
        from ..cpp import native

        return native.BVH(mesh.vertices, mesh.triangles).cast(
            np.asarray(rays_o), np.asarray(rays_d))
    if backend != "device":
        raise ValueError(f"unknown ray-cast backend {backend!r}: 'native' "
                         "or 'device'")
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    v = torch.as_tensor(np.asarray(mesh.vertices, np.float64), **f64)
    t = torch.as_tensor(np.asarray(mesh.triangles, np.int64), device=dev)
    p0 = v[t[:, 0]]
    e1 = v[t[:, 1]] - p0
    e2 = v[t[:, 2]] - p0
    ro = torch.as_tensor(np.asarray(rays_o, np.float64), **f64)
    rd = torch.as_tensor(np.asarray(rays_d, np.float64), **f64)
    n, m = ro.shape[0], t.shape[0]
    t_hit = torch.full((n,), float("inf"), **f64)
    prim = torch.full((n,), INVALID_ID, dtype=torch.int64, device=dev)
    step = max(1, pairs_per_chunk // max(m, 1))
    for s in range(0, n, step):
        o = ro[s:s + step, None, :]                         # (R, 1, 3)
        d = rd[s:s + step, None, :]
        pv = torch.linalg.cross(d.expand(-1, m, -1),
                                e2[None].expand(o.shape[0], -1, -1), dim=-1)
        det = torch.sum(e1[None] * pv, -1)                  # (R, M)
        ok = torch.abs(det) > 1e-14
        inv = 1.0 / torch.where(ok, det, torch.full_like(det, 1e-14))
        tv = o - p0[None]
        u = torch.sum(tv * pv, -1) * inv
        del pv
        qv = torch.linalg.cross(tv, e1[None].expand_as(tv), dim=-1)
        del tv
        w = torch.sum(d * qv, -1) * inv
        tt = torch.sum(e2[None] * qv, -1) * inv
        del qv
        ok &= ((u >= -1e-9) & (u <= 1 + 1e-9) & (w >= -1e-9)
               & (u + w <= 1 + 1e-9) & (tt > 1e-12))
        tt = torch.where(ok, tt, torch.full_like(tt, float("inf")))
        best_t, best = torch.min(tt, dim=1)
        hit = torch.isfinite(best_t)
        t_hit[s:s + step] = best_t
        prim[s:s + step] = torch.where(hit, best, torch.full_like(best,
                                                                  INVALID_ID))
    return t_hit.cpu().numpy(), prim.cpu().numpy()
