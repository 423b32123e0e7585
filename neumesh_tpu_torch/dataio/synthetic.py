"""Synthetic scaffolds and scenes (own copy of
neumesh_tpu/dataio/synthetic.py): the icosphere and UV-sphere meshes, and
DTU-format scene writers (image/ and mask/ PNGs, cameras.npz) for an
analytic lambertian sphere and for sphere-traced exact-SDF scenes (the
torus + offset sphere of the quality gate), each seen from a ring of
cameras. Every array and PNG pixel equals the JAX package's."""
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


def torus_union_sdf(p: np.ndarray, R: float = 0.32, r: float = 0.14,
                    sphere_c=(0.0, 0.12, 0.0), sphere_r: float = 0.15):
    """Exact SDF of a non-convex scene: a torus (axis y) unioned with an
    offset sphere poking through its hole. Rays through the tube cross the
    surface 4 times; the front tube self-occludes the rear tube and the
    sphere. p: (..., 3) -> (...,)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    q = np.sqrt(x * x + z * z) - R
    d_torus = np.sqrt(q * q + y * y) - r
    sc = np.asarray(sphere_c)
    d_sphere = np.linalg.norm(p - sc, axis=-1) - sphere_r
    return np.minimum(d_torus, d_sphere)


def _sdf_normal(sdf_fn, p, eps: float = 1e-4):
    n = np.stack([
        sdf_fn(p + np.array([eps, 0, 0])) - sdf_fn(p - np.array([eps, 0, 0])),
        sdf_fn(p + np.array([0, eps, 0])) - sdf_fn(p - np.array([0, eps, 0])),
        sdf_fn(p + np.array([0, 0, eps])) - sdf_fn(p - np.array([0, 0, eps])),
    ], -1)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def sdf_scene_rgb(rays_o: np.ndarray, rays_d: np.ndarray, sdf_fn,
                  t_min: float = 0.5, t_max: float = 4.5,
                  n_iters: int = 192, hit_eps: float = 2e-4):
    """Sphere-traced analytic render of an exact-SDF scene: two-light
    lambertian with a mild position-based albedo modulation. Returns
    (rgb (N, 3), mask (N,), t_hit (N,))."""
    t = np.full(rays_o.shape[0], t_min, np.float64)
    alive = np.ones(rays_o.shape[0], bool)
    for _ in range(n_iters):
        p = rays_o + t[:, None] * rays_d
        d = sdf_fn(p)
        t = np.where(alive, t + d, t)
        alive = alive & (np.abs(d) > hit_eps) & (t < t_max)
        if not alive.any():
            break
    hit = ~alive & (t < t_max)
    pts = rays_o + t[:, None] * rays_d
    normal = _sdf_normal(sdf_fn, pts)
    l1 = np.asarray([0.4, -0.5, -0.77])
    l1 = l1 / np.linalg.norm(l1)
    l2 = np.asarray([-0.6, 0.6, 0.5])
    l2 = l2 / np.linalg.norm(l2)
    lam = (0.15 + 0.7 * np.clip(-(normal @ l1), 0.0, 1.0)
           + 0.35 * np.clip(-(normal @ l2), 0.0, 1.0))
    albedo = np.asarray([0.75, 0.45, 0.3]) + 0.2 * np.stack([
        np.sin(6.0 * pts[:, 0]), np.sin(6.0 * pts[:, 1]),
        np.cos(6.0 * pts[:, 2])], -1)
    rgb = np.clip(lam[:, None] * albedo, 0.0, 1.0)
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


def _write_scene(out_dir: str, n_views: int, H: int, W: int,
                 cam_dist: float, focal: float, seed: int, el_range,
                 shade):
    """Write image/ and mask/ PNGs and cameras.npz for n_views cameras on
    a ring (azimuth evenly spaced, elevation uniform in el_range degrees
    from a numpy seed); shade(rays_o, rays_d) -> (rgb, mask, t)."""
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)
    cam_dict = {}
    rng = np.random.default_rng(seed)
    for vi in range(n_views):
        az = 2 * np.pi * vi / n_views
        el = np.deg2rad(rng.uniform(*el_range))
        K, c2w = make_camera(az, el, cam_dist, H, W, focal)
        ro, rd = rays_for_camera(K, c2w, H, W)
        rgb, mask, _ = shade(ro, rd)
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


def generate_sphere_scene(out_dir: str, n_views: int = 12, H: int = 64,
                          W: int = 64, radius: float = 0.5,
                          cam_dist: float = 2.5, focal: float = 80.0):
    """Write a DTU-format dataset directory; returns out_dir."""
    return _write_scene(out_dir, n_views, H, W, cam_dist, focal, 7,
                        (-25, 25),
                        lambda ro, rd: sphere_scene_rgb(ro, rd, radius))


def generate_sdf_scene(out_dir: str, sdf_fn, n_views: int = 20,
                       H: int = 128, W: int = 128, cam_dist: float = 2.5,
                       focal: float = 160.0, seed: int = 11,
                       el_range=(-35.0, 35.0)):
    """Write a DTU-format dataset directory for an exact-SDF scene
    (sphere-traced ground truth); returns out_dir."""
    return _write_scene(out_dir, n_views, H, W, cam_dist, focal, seed,
                        el_range,
                        lambda ro, rd: sdf_scene_rgb(ro, rd, sdf_fn))


def generate_torus_scene(out_dir: str, n_views: int = 20, H: int = 128,
                         W: int = 128, cam_dist: float = 2.5,
                         focal: float = 160.0):
    """The non-convex multi-crossing gate scene (torus + offset sphere):
    views through the hole (the sphere partly occluded by the tube) and
    edge-on (4 crossings a ray)."""
    return generate_sdf_scene(out_dir, torus_union_sdf, n_views=n_views,
                              H=H, W=W, cam_dist=cam_dist, focal=focal)


def sphere_mesh(radius: float = 0.5, n_theta: int = 48, n_phi: int = 96):
    """UV-sphere TriangleMesh with outward normals."""
    thetas = np.linspace(1e-3, np.pi - 1e-3, n_theta)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    x = radius * np.sin(tt) * np.cos(pp)
    y = radius * np.sin(tt) * np.sin(pp)
    z = radius * np.cos(tt)
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], -1)
    tris = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            tris.append([a, b, c])
            tris.append([b, d, c])
    mesh = TriangleMesh(verts, np.asarray(tris, dtype=np.int64))
    normals = mesh.compute_vertex_normals()
    if np.mean(np.sum(normals * verts, axis=-1)) < 0:
        mesh.triangles = mesh.triangles[:, ::-1].copy()
        mesh.compute_vertex_normals()
    return mesh


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
