"""The benchmark's own inputs: the icosphere prior mesh, DTU-like cameras,
the render CLI's spiral path and the analytic training views.

Nothing here imports the program: the harness hands what this module makes
to the program and to the plain reference alike.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def icosphere(radius: float = 0.5, subdivisions: int = 7):
    """(vertices (V, 3) float64, faces (F, 3) int64) of a subdivided
    icosahedron: 10 * 4**s + 2 vertices, 163,842 at s = 7."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdivisions):
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        edges = np.concatenate([np.stack([a, b], 1), np.stack([b, c], 1),
                                np.stack([c, a], 1)])
        edges.sort(axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        base = len(verts)
        verts = np.concatenate([verts, mid])
        n = len(faces)
        ab, bc, ca = (base + inv.reshape(-1)[i * n:(i + 1) * n]
                      for i in range(3))
        faces = np.concatenate([np.stack([a, ab, ca], 1),
                                np.stack([b, bc, ab], 1),
                                np.stack([c, ca, bc], 1),
                                np.stack([ab, bc, ca], 1)])
    return verts * radius, faces


def _normalize(v):
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9)


def _view_matrix(forward, up, cam):
    rot_z = _normalize(forward)
    rot_x = _normalize(np.cross(up, rot_z))
    rot_y = _normalize(np.cross(rot_z, rot_x))
    mat = np.stack((rot_x, rot_y, rot_z, cam), axis=-1)
    return np.concatenate([mat, [[0.0, 0.0, 0.0, 1.0]]], axis=0)


def dtu_cameras(cam: dict):
    """`cam["views"]` camera-to-world poses (V, 4, 4) float64 on a
    spherical cap at `cam["distance"]` looking at the origin (OpenCV
    convention), rows of elevations by columns of azimuths, and the
    full-resolution intrinsics (4, 4)."""
    rows, cols = cam["grid"]
    els = np.radians(np.linspace(*cam["elevation_deg"], rows))
    azs = np.radians(np.linspace(*cam["azimuth_deg"], cols))
    poses = []
    for el in els:
        for az in azs:
            c = cam["distance"] * np.array([math.cos(el) * math.sin(az),
                                            -math.sin(el),
                                            -math.cos(el) * math.cos(az)])
            poses.append(_view_matrix(-c, np.array([0.0, -1.0, 0.0]), c))
    K = np.eye(4)
    K[0, 0] = K[1, 1] = cam["focal"]
    K[0, 2], K[1, 2] = cam["cx"], cam["cy"]
    return np.stack(poses[:cam["views"]]), K


def spiral_path(poses: np.ndarray, n_views: int):
    """The render CLI's `spiral` camera path around `poses` (its default
    branch: the average pose, percentile radii, focus at 0.8 of the mean
    camera distance, one turn)."""
    center = poses[:, :3, 3].mean(0)
    avg = _view_matrix(poses[:, :3, 2].sum(0), poses[:, :3, 1].sum(0),
                       center)
    focus = 0.8 * np.mean(np.linalg.norm(poses[:, :3, 3], axis=-1))
    up = _normalize(poses[:, :3, 1].sum(0))
    rads = np.array([np.percentile(np.abs(poses[:, 0, 3]), 10),
                     np.percentile(np.abs(poses[:, 1, 3]), 15),
                     np.percentile(np.abs(poses[:, 2, 3]), 30), 1.0])
    target = avg[:3, :4] @ np.array([0, 0, focus, 1.0])
    out = []
    for th in np.linspace(0.0, 2.0 * np.pi, n_views + 1)[:-1]:
        loc = avg[:3, :4] @ (np.array([np.cos(th), np.sin(th), 0.0, 1.0])
                             * rads)
        out.append(_view_matrix(target - loc, up, loc))
    return np.stack(out)


def scaled_intrinsics(K: np.ndarray, downscale: float) -> np.ndarray:
    K = K.copy()
    K[:2, :3] /= downscale
    return K


def pixel_rays(c2w, K, pix, W: int):
    """Rays through pixel centres of raster indices `pix` (N,) as the
    render CLI makes them: the camera-space direction normalised, then
    rotated. c2w, K: (4, 4) tensors; -> (o (N, 3), d (N, 3))."""
    i = (pix % W).to(c2w.dtype)
    j = (pix // W).to(c2w.dtype)
    x = (i - K[0, 2]) / K[0, 0]
    y = (j - K[1, 2]) / K[1, 1]
    d = torch.stack([x, y, torch.ones_like(x)], -1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d = d @ c2w[:3, :3].T
    return c2w[:3, 3].expand_as(d), d


def hits_sphere(o, d, r: float):
    """Rays whose line passes within r of the origin in front of the
    origin's closest approach (the segment meets the sphere)."""
    dn = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    t = -torch.sum(o * dn, -1)
    closest = o + t[..., None] * dn
    inside0 = torch.linalg.vector_norm(o, dim=-1) < r
    return inside0 | ((t > 0) & (torch.linalg.vector_norm(closest, dim=-1)
                                 < r))


def analytic_view(c2w, K, H: int, W: int, radius: float):
    """The analytic scene at full resolution: a sphere of `radius` with a
    smooth procedural albedo under a fixed light, black background.
    -> (rgb (H*W, 3) float32, mask (H*W,) bool), on c2w's device."""
    pix = torch.arange(H * W, device=c2w.device)
    o, d = pixel_rays(c2w, K, pix, W)
    b = torch.sum(o * d, -1)
    c = torch.sum(o * o, -1) - radius * radius
    disc = b * b - c
    mask = disc > 0
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    p = o + t[:, None] * d
    n = p / radius
    albedo = 0.5 + 0.4 * torch.sin(torch.stack(
        [9.0 * p[:, 0] + 3.0 * p[:, 1], 7.0 * p[:, 1] - 5.0 * p[:, 2],
         11.0 * p[:, 2] + 2.0 * p[:, 0]], -1))
    light = torch.tensor([0.3, -0.8, -0.5], device=c2w.device,
                         dtype=c2w.dtype)
    shade = 0.3 + 0.7 * torch.clamp(n @ (light / light.norm()), min=0.0)
    rgb = torch.where(mask[:, None], albedo * shade[:, None],
                      torch.zeros_like(albedo))
    return rgb.to(torch.float32), mask
