"""Geometry helpers (counterpart of neumesh_tpu/ops/geo.py): barycentric
coordinates of points projected onto triangles (Heidrich's method) and
affine transforms of vertices and directions, on torch tensors of any
leading shape."""
from __future__ import annotations

import torch


def barycentric_coordinates(p, a, b, c):
    """Barycentric coords of p projected on triangle (a, b, c). All inputs
    (..., 3); returns (..., 3) = (u, v, w) with p ~ u a + v b + w c
    (Heidrich 2005)."""
    ab = b - a
    ac = c - a
    ap = p - a
    n = torch.linalg.cross(ab, ac, dim=-1)
    n_norm2 = torch.sum(n * n, dim=-1, keepdim=True)
    n_norm2 = torch.where(n_norm2 < 1e-20, torch.full_like(n_norm2, 1e-20),
                          n_norm2)
    v = torch.sum(torch.linalg.cross(ab, ap, dim=-1) * n, dim=-1,
                  keepdim=True) / n_norm2
    w = torch.sum(torch.linalg.cross(ap, ac, dim=-1) * n, dim=-1,
                  keepdim=True) / n_norm2
    u = 1.0 - v - w
    # with this cross order (u, w, v) multiply (a, b, c)
    return torch.cat([u, w, v], dim=-1)


def transform_vertices(R, t, vertices):
    """(3, 3) rotation (and scale) and (3,) translation applied to
    (..., 3) vertices."""
    R = torch.as_tensor(R, dtype=vertices.dtype, device=vertices.device)
    t = torch.as_tensor(t, dtype=vertices.dtype, device=vertices.device)
    return vertices @ R.T + t


def transform_direction(R, directions):
    """Rotate (..., 3) directions, no translation; a scale in R is kept
    (the result is not re-normalised)."""
    R = torch.as_tensor(R, dtype=directions.dtype, device=directions.device)
    return directions @ R.T
