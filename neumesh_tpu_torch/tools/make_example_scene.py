"""Build the synthetic example scene of the editing configs
(counterpart of tools/make_example_scene.py), with the port:

    <root>/
      data/          synthetic DTU-format dataset (image/, mask/, cameras.npz)
      paint_data/    a painted copy of the dataset with paint_mask/ images
      prior_mesh.ply icosphere NeuMesh scaffold
      neus/          small NeuS teacher config + ckpts/latest.ckpt
      neumesh/       small NeuMesh config + ckpts/latest.ckpt
      editing/       mask meshes, uv charts, the deformed scaffold, corr.json

    python -m neumesh_tpu_torch.tools.make_example_scene --root examples/scene \\
        [--train-steps N] [--device cpu]

configs/editing/*.json point at examples/scene/ relative to the
repository root. The scene is written under --root and nowhere else.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from ..config import ConfigDict, save_yaml
from ..dataio.synthetic import generate_sphere_scene, icosphere_mesh
from ..mesh.triangle_mesh import TriangleMesh, save_ply
from ..utils.image_io import read_png, write_png


def neus_config(root):
    return ConfigDict({
        "expname": "neus_example",
        "device_ids": [0],
        "data": {
            "type": "DTU", "data_dir": os.path.join(root, "data"),
            "downscale": 1, "N_rays": 72, "batch_size": 1,
            "val_downscale": 4.0, "val_rayschunk": 256,
            "obj_bounding_radius": 1.0,
        },
        "model": {
            "framework": "NeuS", "obj_bounding_radius": 1.0,
            "W_geometry_feature": 32,
            "variance_init": 0.05,
            "surface": {"D": 2, "W": 32, "skips": [], "embed_multires": 4,
                        "radius_init": 0.6},
            "radiance": {"D": 2, "W": 32, "embed_multires": -1,
                         "embed_multires_view": 2},
            "N_upsample_iters": 2, "N_samples": 16, "N_importance": 16,
        },
        "training": {
            "speed_factor": 10.0, "lr": 5e-3, "num_iters": 0,
            "scheduler": {"type": "warmupcosine", "warmup_steps": 20},
            "loss_weights": {"img": 1.0, "mask": 0.5, "eikonal": 0.1},
            "log_root_dir": os.path.join(root, "logs"),
            "i_val": -1, "i_backup": -1, "i_save": 10000, "i_log": 50,
            "monitoring": "none",
        },
    })


def neumesh_config(root):
    return ConfigDict({
        "expname": "neumesh_example",
        "device_ids": [0],
        "data": {
            "type": "DTU", "data_dir": os.path.join(root, "data"),
            "downscale": 1, "N_rays": 72, "batch_size": 1,
            "val_downscale": 4.0, "val_rayschunk": 256,
            "obj_bounding_radius": 1.0,
        },
        "model": {
            "framework": "NeuMesh",
            "prior_mesh": os.path.join(root, "prior_mesh.ply"),
            "distance_method": "grid",
            "D_density": 2, "D_color": 2, "W": 32,
            "geometry_dim": 4, "color_dim": 4,
            "multires_d": 4, "multires_fg": 1, "multires_ft": 1,
            "multires_view": 2,
            "bounded_near_far": True, "enable_nablas_input": True,
            "learn_indicator_weight": True,
            "N_upsample_iters": 2, "N_samples": 16, "N_importance": 16,
            "max_candidates": 64,
        },
        "training": {
            "speed_factor": 10.0, "lr": 5e-3, "num_iters": 0,
            "scheduler": {"type": "warmupcosine", "warmup_steps": 10},
            "loss_weights": {"img": 1.0, "mask": 0.1, "eikonal": 0.1,
                             "distill_density": 1.0, "distill_color": 1.0,
                             "indicator_reg": 0.001},
            "teacher_config": os.path.join(root, "neus", "config.yaml"),
            "teacher_ckpt": os.path.join(root, "neus", "ckpts",
                                         "latest.ckpt"),
            "log_root_dir": os.path.join(root, "logs"),
            "i_val": -1, "i_backup": -1, "i_save": 10000, "i_log": 20,
            "monitoring": "none",
        },
    })


def _save_model_ckpt(exp_dir, args, train_steps, seed, device):
    """config.yaml and ckpts/latest.ckpt (initial or briefly trained)."""
    from ..models import build_framework
    from ..train.loop import main_function
    from ..utils.checkpoints import CheckpointIO

    os.makedirs(exp_dir, exist_ok=True)
    save_yaml(args, os.path.join(exp_dir, "config.yaml"))
    if train_steps > 0:
        args = ConfigDict(args.to_dict())
        args.training.num_iters = train_steps
        args.training.log_root_dir = os.path.join(exp_dir, "_train")
        args["device"] = device
        model = main_function(args)["model"]
    else:
        model, *_ = build_framework(args, args.model.framework,
                                    device=device, seed=seed)
    CheckpointIO(os.path.join(exp_dir, "ckpts")).save(
        "latest.ckpt", model=model, global_step=train_steps, epoch_idx=0)


def band_mask_mesh(mesh, lo, hi, color):
    """A copy of `mesh` with the vertices of the z-band [lo, hi] coloured
    `color`, every other vertex black (the swap CLIs' mask convention);
    and the band's mask."""
    colors = np.zeros((mesh.n_vertices, 3), np.float64)
    band = (mesh.vertices[:, 2] >= lo) & (mesh.vertices[:, 2] <= hi)
    colors[band] = color
    return TriangleMesh(mesh.vertices.copy(), mesh.triangles.copy(),
                        vertex_colors=colors), band


def uv_chart_mesh(mesh, band):
    """A copy of `mesh` with a spherical-coordinate uv chart on the `band`
    vertices and uv 0 elsewhere (the filling CLIs' chart convention)."""
    v = mesh.vertices
    theta = np.arccos(np.clip(v[:, 2] / np.linalg.norm(v, axis=-1), -1, 1))
    phi = np.mod(np.arctan2(v[:, 1], v[:, 0]), 2 * np.pi)
    uv = np.stack([phi / (2 * np.pi), theta / np.pi], -1)
    uv[~band] = 0.0
    # charted uvs stay strictly nonzero (norm > 1e-8 marks "has uv")
    uv[band] = np.clip(uv[band], 1e-3, 1.0)
    return TriangleMesh(mesh.vertices.copy(), mesh.triangles.copy(),
                        vertex_uvs=uv)


def deformed_mesh(mesh, amp=0.08, freq=6.0):
    """The wave-deformed scaffold: radii scaled by 1 + amp sin(freq z /
    max radius)."""
    v = mesh.vertices.copy()
    r = np.linalg.norm(v, axis=-1, keepdims=True)
    v *= 1.0 + amp * np.sin(freq * v[:, 2:3] / r.max())
    out = TriangleMesh(v, mesh.triangles.copy())
    out.compute_vertex_normals()
    return out


def paint_dataset(src, dst, center=(0.25, 0.05), radius=0.18):
    """Copy the dataset and paint a white disc (image-plane fraction
    coordinates) over the object in every view, with matching
    paint_mask/ images."""
    shutil.copytree(src, dst, dirs_exist_ok=True)
    os.makedirs(os.path.join(dst, "paint_mask"), exist_ok=True)
    img_dir = os.path.join(dst, "image")
    for name in sorted(os.listdir(img_dir)):
        img = read_png(os.path.join(img_dir, name)).astype(np.float64)
        H, W = img.shape[:2]
        jj, ii = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        du = ii / W - 0.5 - center[0] * 0.5
        dv = jj / H - 0.5 - center[1] * 0.5
        disc = du * du + dv * dv < radius * radius
        # only over the object, so every paint ray hits the mesh
        mask = read_png(os.path.join(dst, "mask", name)).reshape(
            H, W, -1)[..., 0] > 127
        disc &= mask
        img[disc] = [255.0, 255.0, 255.0]
        write_png(os.path.join(img_dir, name), img.astype(np.uint8))
        write_png(os.path.join(dst, "paint_mask", name),
                  (disc * 255).astype(np.uint8))


def pick_corr(mesh, main_band, ref_band, n=5):
    """n (main vertex, reference vertex) pairs: evenly spaced azimuths
    matched between the two bands."""
    idx_main = np.where(main_band)[0]
    idx_ref = np.where(ref_band)[0]
    phi = np.arctan2(mesh.vertices[:, 1], mesh.vertices[:, 0])
    pairs = []
    for target in np.linspace(-np.pi * 0.8, np.pi * 0.8, n):
        mi = idx_main[np.argmin(np.abs(phi[idx_main] - target))]
        ri = idx_ref[np.argmin(np.abs(phi[idx_ref] - target))]
        pairs.append([int(mi), int(ri)])
    return pairs


def write_editing_assets(mesh, edit_dir):
    """The mask meshes, uv charts, deformed scaffold and corr.json of the
    editing configs, for `mesh` (z-bands [0.15, 0.45] and [-0.45,
    -0.15])."""
    os.makedirs(edit_dir, exist_ok=True)
    top_mesh, top_band = band_mask_mesh(mesh, 0.15, 0.45, (1.0, 0.2, 0.2))
    bot_mesh, bot_band = band_mask_mesh(mesh, -0.45, -0.15, (0.2, 0.2, 1.0))
    save_ply(top_mesh, os.path.join(edit_dir, "mask_top.ply"))
    save_ply(bot_mesh, os.path.join(edit_dir, "mask_bottom.ply"))
    save_ply(uv_chart_mesh(mesh, top_band),
             os.path.join(edit_dir, "uv_main.ply"))
    save_ply(uv_chart_mesh(mesh, bot_band),
             os.path.join(edit_dir, "uv_ref.ply"))
    save_ply(deformed_mesh(mesh), os.path.join(edit_dir, "deformed.ply"))
    with open(os.path.join(edit_dir, "corr.json"), "w") as f:
        json.dump({"corr": pick_corr(mesh, top_band, bot_band)}, f)


def main(root, train_steps=0, n_views=8, hw=48, device="cuda"):
    os.makedirs(root, exist_ok=True)
    print(f"=> dataset ({n_views} views @ {hw}x{hw})")
    generate_sphere_scene(os.path.join(root, "data"), n_views=n_views,
                          H=hw, W=hw)
    print("=> scaffold mesh")
    mesh = icosphere_mesh(radius=0.5, subdivisions=3)   # 642 vertices
    mesh.compute_vertex_normals()
    save_ply(mesh, os.path.join(root, "prior_mesh.ply"))
    print("=> NeuS teacher ckpt" + (f" (training {train_steps} steps)"
                                    if train_steps else " (init)"))
    _save_model_ckpt(os.path.join(root, "neus"), neus_config(root),
                     train_steps, 0, device)
    print("=> NeuMesh ckpt" + (f" (training {train_steps} steps)"
                               if train_steps else " (init)"))
    _save_model_ckpt(os.path.join(root, "neumesh"), neumesh_config(root),
                     train_steps, 1, device)
    print("=> editing assets")
    write_editing_assets(mesh, os.path.join(root, "editing"))
    print("=> paint dataset")
    paint_dataset(os.path.join(root, "data"),
                  os.path.join(root, "paint_data"))
    print(f"done: scene at {root}")


def create_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="directory to write the scene into (the editing "
                         "configs expect examples/scene)")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="train the NeuS/NeuMesh pair this many steps "
                         "(0 = save untrained initial checkpoints)")
    ap.add_argument("--n-views", type=int, default=8)
    ap.add_argument("--hw", type=int, default=48)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    return ap


if __name__ == "__main__":
    a = create_parser().parse_args()
    main(a.root, a.train_steps, a.n_views, a.hw, a.device)
