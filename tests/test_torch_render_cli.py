"""The port's render CLI (neumesh_tpu_torch.cli.render, --device cpu)
against the repository's render.py on a 24x24 synthetic DTU-format scene
with a small NeuMesh (W = 32) given as a reference-format .pt: the rgb and
normal PNGs of both agree within 1 in 8 bits on >= 99.9% of the pixels,
in volume mode here and in surface mode in test_torch_render_cli_surface.py,
each on the context math and on the fused route (use_pallas; the JAX
package's Pallas kernels in interpret mode, the port's plain versions).

The mesh is an icosphere with its vertices jittered: exact kNN ties of
the symmetric sphere would let the two packages' candidate-grid builds
(scipy's cKDTree, the JAX package's KD-tree) break them differently."""
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from neumesh_tpu_torch.ops import kernels
from neumesh_tpu_torch.utils.image_io import read_png

SMALL = dict(D_density=3, D_color=2, W=32, geometry_dim=8, color_dim=8,
             multires_d=4, multires_fg=1, multires_ft=1, multires_view=2,
             enable_nablas_input=True, learn_indicator_weight=True)


@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory):
    """(config path, checkpoint path): a 4-view 24x24 sphere scene, the
    jittered icosphere as .ply, a model whose vertex codes vary smoothly
    over the mesh (as trained codes do) as .pt, and a config naming them."""
    from neumesh_tpu_torch.config import save_yaml
    from neumesh_tpu_torch.dataio.synthetic import (generate_sphere_scene,
                                                    icosphere_mesh)
    from neumesh_tpu_torch.mesh.grid import MeshGrid
    from neumesh_tpu_torch.mesh.triangle_mesh import save_ply
    from neumesh_tpu_torch.models.neumesh.model import NeuMesh
    from neumesh_tpu_torch.utils.state import save_reference_pt
    d = str(tmp_path_factory.mktemp("cli"))
    generate_sphere_scene(os.path.join(d, "scene"), n_views=4, H=24, W=24,
                          focal=30.0)
    mesh = icosphere_mesh(0.5, 3)
    rng = np.random.default_rng(5)
    mesh.vertices = mesh.vertices + rng.normal(size=mesh.vertices.shape) \
        * 2e-3
    mesh.compute_vertex_normals()
    save_ply(mesh, os.path.join(d, "mesh.ply"))
    m = NeuMesh(MeshGrid(mesh, device="cpu"), device="cpu", speed_factor=10.0,
                **SMALL).init(0)
    v = m.mesh_grid.vertices
    with torch.no_grad():
        for p in (m.geometry_features, m.color_features):
            A = torch.as_tensor(rng.normal(size=(3, p.shape[1])) * 2.0,
                                dtype=torch.float32)
            b = torch.as_tensor(rng.uniform(0, 6.3, p.shape[1]),
                                dtype=torch.float32)
            p.copy_(torch.sin(v @ A + b))
    pt = save_reference_pt(os.path.join(d, "model.pt"), m)
    cfg = {"expname": "cli", "data": {
        "type": "DTU", "data_dir": os.path.join(d, "scene"), "downscale": 1,
        "batch_size": 1, "obj_bounding_radius": 1.0},
        "model": {"framework": "NeuMesh",
                  "prior_mesh": os.path.join(d, "mesh.ply"), **SMALL},
        "training": {"speed_factor": 10.0, "loss_weights": {"eikonal": 0.1}}}
    path = os.path.join(d, "config.yaml")
    save_yaml(cfg, path)
    return path, pt


def run_both(cli_scene, tmp_path, monkeypatch, mode, use_pallas):
    """render.py and the port's CLI on the same flags (one device, one
    spiral view); returns the port's result dict."""
    import render as jrender
    from neumesh_tpu.config import create_args_parser as jparser
    from neumesh_tpu.config import load_config as jload
    from neumesh_tpu_torch.cli import render as trender
    cfg, pt = cli_scene
    monkeypatch.chdir(tmp_path)
    flags = ["--config", cfg, "--load_pt", pt, "--render_mode", mode,
             "--model:use_pallas", use_pallas, "--num_views", "1",
             "--volume_devices", "1", "--surface_devices", "1",
             "--surface_steps", "32"]
    a, u = jrender.create_render_args(jparser()).parse_known_args(
        flags + ["--outbase", "jax"])
    jrender.main_function(jload(a, u))
    kernels.reset_launch_counts()
    out = trender.main(flags + ["--outbase", "port", "--device", "cpu"])
    # the CPU ran the plain versions: no kernel launched
    assert all(v == 0 for modes in kernels.LAUNCHES.values()
               for v in modes.values())
    return out


def assert_pngs_agree(out):
    for sub, kind, frame in (("", "rgb", out["rgb"][0]),
                             ("normal", "normal", out["normals"][0] / 2 + .5)):
        jax_png = imageio.imread(os.path.join("out", "jax", sub,
                                              f"jax_{kind}_000.png"))
        path = os.path.join("out", "port", sub, f"port_{kind}_000.png")
        port_png = read_png(path)
        np.testing.assert_array_equal(port_png, imageio.imread(path))
        np.testing.assert_array_equal(
            port_png, (np.clip(frame, 0, 1) * 255).astype(np.uint8))
        assert port_png.shape == (24, 24, 3)
        err = np.abs(port_png.astype(int) - jax_png.astype(int)).max(-1)
        assert (err <= 1).mean() >= 0.999, (kind, (err <= 1).mean(),
                                            err.max())


@pytest.mark.parametrize("use_pallas", ["false", "true"])
def test_volume_cli_matches_render_py(cli_scene, tmp_path, monkeypatch,
                                      use_pallas):
    out = run_both(cli_scene, tmp_path, monkeypatch, "volume", use_pallas)
    assert_pngs_agree(out)
    assert out["mrays_s"] > 0 and len(out["view_s"]) == 1


def test_cli_raises_without_a_card_and_for_several_devices(cli_scene,
                                                           tmp_path,
                                                           monkeypatch):
    from neumesh_tpu_torch.cli import render as trender
    cfg, pt = cli_scene
    monkeypatch.chdir(tmp_path)
    base = ["--config", cfg, "--load_pt", pt, "--num_views", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trender.main(base)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trender.main(base + ["--volume_devices", "2"])
    # several devices no longer raise: with --device cpu they are CPU
    # replicas (their frames against one device: the test below)
    for flags in (["--volume_devices", "2"],
                  ["--render_mode", "surface", "--surface_devices", "4"]):
        out = trender.main(base + ["--device", "cpu", "--outbase", "n"]
                           + flags)
        assert np.isfinite(out["rgb"][0]).all()
    out = trender.main(base + ["--device", "cpu", "--disable_rgb"])
    assert out["files"] == [] and os.path.isdir(os.path.join("out", "cli",
                                                             "normal"))


@pytest.mark.parametrize("mode,flags", [
    ("volume", ["--volume_devices"]),
    ("surface", ["--surface_scan", "distance", "--surface_devices"])])
def test_cli_on_two_devices_matches_one_device(cli_scene, tmp_path,
                                               monkeypatch, mode, flags):
    """--volume_devices 2 / --surface_devices 2 on the CPU, dataset view
    0: each chunk's rays split over two CPU replicas of the model (the
    last chunk edge-padded to an even count), the frames those of
    --*_devices 1 (f32 rounding: the plain versions' matmuls see other
    row counts)."""
    from neumesh_tpu_torch.cli import render as trender
    cfg, pt = cli_scene
    monkeypatch.chdir(tmp_path)
    base = ["--config", cfg, "--load_pt", pt, "--camera_path", "dataset",
            "--camera_inds", "0", "--render_mode", mode,
            "--surface_steps", "32", "--rayschunk", "250",
            "--device", "cpu"] + flags
    one = trender.main(base + ["1", "--outbase", "one"])
    two = trender.main(base + ["2", "--outbase", "two"])
    for key in ("rgb", "normals", "depth"):
        np.testing.assert_allclose(two[key][0], one[key][0], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
        assert float(np.std(one[key][0])) > 1e-3, key
