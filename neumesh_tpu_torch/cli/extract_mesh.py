"""Mesh extraction CLI (counterpart of the repository's extract_mesh.py).

The model's SDF on a dense N^3 grid, evaluated on the model's device in
`chunk`-point batches without autograd (forward_density_only of a NeuS or
a NeuMesh); the isosurface extracted on the host by the C++ marching
tetrahedra (default) or marching cubes (--method mc) of the port's host
library, in the JAX package's vertex order; vertex
colours queried at the vertices with view direction = -vertex normal;
written as extracted_<obj_id>.ply and bbox_<obj_id>.json.

    python -m neumesh_tpu_torch.cli.extract_mesh --config <yaml> \\
        [--ckpt_path <.ckpt|.pt>] [extract_mesh.py's flags] [--device cpu]

The checkpoint is a torch zip (the port's `.ckpt`, a reference `.pt`) or
the JAX package's native msgpack `.ckpt`; without --ckpt_path the last of
<training.exp_dir>/ckpts. Runs on the card unless --device cpu is given;
without a card and without that flag it raises.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device, set_fp32_precision
from ..config import create_args_parser, load_config
from ..mesh.marching_cubes import extract_isosurface
from ..mesh.triangle_mesh import save_ply
from ..models import build_framework
from ..utils.checkpoints import CheckpointIO, sorted_ckpts

log = logging.getLogger("neumesh_tpu_torch")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def evaluate_grid_sdf(model, N, x_range, y_range, z_range, chunk=65536):
    """The SDF at the N^3 grid points (indexing 'ij', float32 coordinates
    of float64 linspaces, as the JAX package casts them): (N, N, N) f32
    numpy. The points of a chunk are made on the model's device from
    their flat indices."""
    dev = model.device
    axes = [torch.as_tensor(np.linspace(r[0], r[1], N).astype(np.float32),
                            device=dev) for r in (x_range, y_range, z_range)]
    out = torch.empty(N ** 3, dtype=torch.float32, device=dev)
    for i in range(0, N ** 3, chunk):
        idx = torch.arange(i, min(i + chunk, N ** 3), device=dev)
        pts = torch.stack([axes[0][idx // (N * N)], axes[1][idx // N % N],
                           axes[2][idx % N]], -1)
        out[i:i + chunk] = model.forward_density_only(pts).reshape(-1)
    return out.reshape(N, N, N).cpu().numpy()


@torch.no_grad()
def evaluate_vertex_colors(model, vertices, normals, chunk=65536):
    """rgb (V, 3) f32 numpy at the vertices, viewed along -normal."""
    dev = model.device
    verts = np.asarray(vertices, np.float32)
    dirs = -np.asarray(normals, np.float32)
    out = []
    for i in range(0, len(verts), chunk):
        _, rgb = model.forward(torch.as_tensor(verts[i:i + chunk],
                                               device=dev),
                               torch.as_tensor(dirs[i:i + chunk],
                                               device=dev))
        out.append(rgb.float().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, 3), np.float32)


def extract_mesh(model, N_grid, x_range, y_range, z_range, sdf_th, chunk,
                 scale_factor, output_dir, obj_id, method="mt", stats=None):
    """Grid SDF -> isosurface -> vertex colours -> PLY + bbox JSON. Returns
    the TriangleMesh. `stats`, a dict, receives the host seconds of the
    three stages (each ending in a device synchronize): grid_s, march_s,
    color_s."""
    dev = model.device
    if dev.type == "cuda":
        set_fp32_precision()        # true-f32 matmuls, as the renderers
    t0 = time.perf_counter()
    log.info("Predicting occupancy ...")
    sdf = evaluate_grid_sdf(model, N_grid, x_range, y_range, z_range, chunk)
    _sync(dev)
    t1 = time.perf_counter()
    log.info("Extracting mesh ...")
    spacing = ((x_range[1] - x_range[0]) / (N_grid - 1),
               (y_range[1] - y_range[0]) / (N_grid - 1),
               (z_range[1] - z_range[0]) / (N_grid - 1))
    origin = (x_range[0], y_range[0], z_range[0])
    mesh = extract_isosurface(sdf, sdf_th, origin, spacing, method=method)
    if mesh.n_triangles == 0:
        raise ValueError(f"no isosurface at sdf_th={sdf_th}: the SDF spans "
                         f"[{sdf.min():.4g}, {sdf.max():.4g}] on the grid")
    mesh.vertices = mesh.vertices * scale_factor
    log.info(f"  {mesh.n_vertices} vertices, {mesh.n_triangles} triangles")
    t2 = time.perf_counter()

    log.info("Predicting color ...")
    normals = mesh.compute_vertex_normals()
    colors = evaluate_vertex_colors(model, mesh.vertices, normals, chunk)
    mesh.vertex_colors = np.clip(np.asarray(colors, np.float64), 0, 1)
    _sync(dev)
    t3 = time.perf_counter()
    if stats is not None:
        stats.update(grid_s=t1 - t0, march_s=t2 - t1, color_s=t3 - t2)

    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, f"extracted_{obj_id}.ply")
    save_ply(mesh, out_path)
    log.info(f"=> Saved {out_path}")

    min_bound = mesh.vertices.min(0)
    max_bound = mesh.vertices.max(0)
    with open(os.path.join(output_dir, f"bbox_{obj_id}.json"), "wt") as f:
        json.dump({
            "max_bound": max_bound.tolist(),
            "min_bound": min_bound.tolist(),
            "size": (max_bound - min_bound).tolist(),
        }, f, indent=4)
    return mesh


def create_extract_args(parser):
    parser.add_argument("--ckpt_path", type=str, default=None)
    parser.add_argument("--N_grid", type=int, default=256)
    parser.add_argument("--sdf_th", type=float, default=0.0)
    parser.add_argument("--chunk", type=int, default=65536)
    parser.add_argument("--scale_factor", type=float, default=1.0)
    parser.add_argument("--x_range", type=float, nargs=2, default=[-1.0, 1.0])
    parser.add_argument("--y_range", type=float, nargs=2, default=[-1.0, 1.0])
    parser.add_argument("--z_range", type=float, nargs=2, default=[-1.0, 1.0])
    parser.add_argument("--output_dir", type=str, default="out")
    parser.add_argument("--obj_id", type=str, default="0")
    parser.add_argument("--method", type=str, default="mt",
                        choices=("mt", "mc"),
                        help="isosurface extractor: marching tetrahedra "
                             "(default; watertight, ~2x triangles) or "
                             "classic marching cubes (the "
                             "PyMCubes-comparable vertex set, reference "
                             "extract_mesh.py:139)")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to evaluate the model on; 'cpu' runs the "
             "kernels' plain versions (tests)")
    return parser


def load_model(config):
    """(model, checkpoint path): the config's framework on config.device
    with the checkpoint's parameters."""
    device = resolve_device(config.get("device", None) or "cuda")
    model, *_ = build_framework(config, config.model.framework,
                                device=device)
    ckpt_path = config.get("ckpt_path", None)
    if ckpt_path is None:
        ckpts = sorted_ckpts(os.path.join(config.training.exp_dir, "ckpts"))
        if not ckpts:
            raise FileNotFoundError("no checkpoint found; pass --ckpt_path")
        ckpt_path = ckpts[-1]
    log.info(f"=> Use ckpt: {ckpt_path}")
    CheckpointIO(os.path.dirname(str(ckpt_path)) or ".").load_file(
        str(ckpt_path), model)
    return model, ckpt_path


def main(argv=None, stats=None):
    """Parse extract_mesh.py's flags (plus --device), load the model and
    extract; returns the TriangleMesh."""
    parser = create_extract_args(create_args_parser())
    args, unknown = parser.parse_known_args(argv)
    config = load_config(args, unknown)
    model, _ = load_model(config)
    return extract_mesh(model, config.N_grid, tuple(config.x_range),
                        tuple(config.y_range), tuple(config.z_range),
                        config.sdf_th, config.chunk, config.scale_factor,
                        config.output_dir, config.obj_id,
                        method=config.get("method", "mt"), stats=stats)


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s",
                        datefmt="%H:%M:%S")
    main()
