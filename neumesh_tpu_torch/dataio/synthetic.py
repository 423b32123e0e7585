"""Synthetic scaffolds and scenes (own copy of the parts of
neumesh_tpu/dataio/synthetic.py the port uses): the icosphere mesh, and a
DTU-format scene writer (image/ and mask/ PNGs, cameras.npz) for an
analytic lambertian sphere seen from a ring of cameras."""
from __future__ import annotations

import os

import numpy as np

from ..mesh.triangle_mesh import TriangleMesh
from ..ops.cameras import look_at
from ..utils.image_io import write_png


def sphere_scene_rgb(rays_o: np.ndarray, rays_d: np.ndarray,
                     radius: float = 0.5):
    """Analytic render: lambertian red-ish sphere, one directional light.
    Returns (rgb (N, 3), mask (N,), t_hit (N,))."""
    b = np.sum(rays_o * rays_d, -1)
    c = np.sum(rays_o * rays_o, -1) - radius**2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit = hit & (t > 0)
    pts = rays_o + t[:, None] * rays_d
    normal = pts / max(radius, 1e-9)
    light = np.asarray([0.4, -0.5, -0.77])
    light = light / np.linalg.norm(light)
    lam = np.clip(-(normal @ light), 0.1, 1.0)
    albedo = np.asarray([0.8, 0.35, 0.25])
    rgb = lam[:, None] * albedo[None, :]
    rgb = np.where(hit[:, None], rgb, 0.0)
    return rgb.astype(np.float32), hit, t


def make_camera(azimuth: float, elevation: float, dist: float, H: int,
                W: int, focal: float):
    """(K 4x4, c2w 4x4) for a camera on the viewing sphere looking at 0."""
    cam = dist * np.asarray([
        np.cos(elevation) * np.sin(azimuth),
        np.sin(elevation),
        -np.cos(elevation) * np.cos(azimuth),
    ])
    c2w = look_at(cam, np.zeros(3)).astype(np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = focal
    K[0, 2] = W / 2.0
    K[1, 2] = H / 2.0
    return K, c2w


def rays_for_camera(K: np.ndarray, c2w: np.ndarray, H: int, W: int):
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    i = i.reshape(-1)
    j = j.reshape(-1)
    dirs = np.stack([(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1],
                     np.ones_like(i)], -1)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()
    return rays_o, rays_d


def generate_sphere_scene(out_dir: str, n_views: int = 12, H: int = 64,
                          W: int = 64, radius: float = 0.5,
                          cam_dist: float = 2.5, focal: float = 80.0):
    """Write a DTU-format dataset directory; returns out_dir."""
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)
    cam_dict = {}
    rng = np.random.default_rng(7)
    for vi in range(n_views):
        az = 2 * np.pi * vi / n_views
        el = np.deg2rad(rng.uniform(-25, 25))
        K, c2w = make_camera(az, el, cam_dist, H, W, focal)
        ro, rd = rays_for_camera(K, c2w, H, W)
        rgb, mask, _ = sphere_scene_rgb(ro, rd, radius)
        img8 = (np.clip(rgb, 0, 1).reshape(H, W, 3) * 255).astype(np.uint8)
        m8 = (mask.reshape(H, W) * 255).astype(np.uint8)
        write_png(os.path.join(out_dir, "image", f"{vi:06d}.png"), img8)
        write_png(os.path.join(out_dir, "mask", f"{vi:06d}.png"), m8)
        w2c = np.linalg.inv(c2w)
        world_mat = np.eye(4, dtype=np.float32)
        world_mat[:3, :4] = K[:3, :3] @ w2c[:3, :4]
        cam_dict[f"world_mat_{vi}"] = world_mat
        cam_dict[f"scale_mat_{vi}"] = np.eye(4, dtype=np.float32)
        cam_dict[f"camera_mat_{vi}"] = K
    np.savez(os.path.join(out_dir, "cameras.npz"), **cam_dict)
    return out_dir


def icosphere_mesh(radius: float = 0.5, subdivisions: int = 5):
    """Subdivided-icosahedron sphere: uniform vertex density (unlike the
    UV sphere, whose pole clustering is pathological for spatial indexing).
    subdivisions=5 -> 10242 verts, 6 -> 40962 verts."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key in edge_mid:
                return edge_mid[key]
            m = verts_list[a] + verts_list[b]
            m = m / np.linalg.norm(m)
            verts_list.append(m)
            edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    mesh = TriangleMesh(verts * radius, faces)
    normals = mesh.compute_vertex_normals()
    if np.mean(np.sum(normals * mesh.vertices, axis=-1)) < 0:
        mesh.triangles = mesh.triangles[:, ::-1].copy()
        mesh.compute_vertex_normals()
    return mesh
