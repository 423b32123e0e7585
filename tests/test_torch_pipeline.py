"""The product pipeline through the port's CLIs on the CPU, at the sizes
of tests/test_e2e_pipeline.py (6 views of 36x36, W 64): train a NeuS
teacher (cli/train.py) -> extract the prior mesh from its checkpoint
(cli/extract_mesh.py) -> distill a NeuMesh student on that mesh
(cli/train.py) -> render a view (cli/render.py) -> score views of the
teacher and the student (cli/eval.py). A few iterations each:
checkpoints exist, the mesh is a sphere, the render and the scores are
finite."""
import json
import os

import numpy as np
import pytest
import torch

from neumesh_tpu_torch.config import ConfigDict, save_yaml

NEUS_ITERS, NEUMESH_ITERS = 40, 8


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def configs(d):
    """(NeuS config path, NeuMesh config path) in directory d."""
    data = {"type": "DTU", "data_dir": os.path.join(d, "scene"),
            "downscale": 1, "N_rays": 72, "batch_size": 1,
            "val_downscale": 4.0, "val_rayschunk": 256,
            "obj_bounding_radius": 1.0}
    common = {"speed_factor": 10.0, "lr": 5e-3,
              "scheduler": {"type": "warmupcosine", "warmup_steps": 10},
              "log_root_dir": os.path.join(d, "logs"), "i_val": -1,
              "i_backup": -1, "i_save": 10000, "i_log": 20,
              "monitoring": "none"}
    neus = ConfigDict({
        "expname": "neus_sphere", "data": data,
        "model": {"framework": "NeuS", "obj_bounding_radius": 1.0,
                  "W_geometry_feature": 64, "variance_init": 0.05,
                  "surface": {"D": 3, "W": 64, "skips": [],
                              "embed_multires": 4, "radius_init": 0.6},
                  "radiance": {"D": 2, "W": 64, "embed_multires": -1,
                               "embed_multires_view": 2},
                  "N_upsample_iters": 2, "N_samples": 24},
        "training": dict(common, num_iters=NEUS_ITERS, loss_weights={
            "img": 1.0, "mask": 0.5, "eikonal": 0.1})})
    teacher = os.path.join(d, "logs", "neus_sphere")
    neumesh = ConfigDict({
        "expname": "neumesh_sphere", "data": data,
        "model": {"framework": "NeuMesh",
                  "prior_mesh": os.path.join(d, "mesh", "extracted_0.ply"),
                  "distance_method": "grid", "D_density": 2, "D_color": 2,
                  "W": 64, "geometry_dim": 8, "color_dim": 8,
                  "multires_d": 4, "multires_fg": 1, "multires_ft": 1,
                  "multires_view": 2, "bounded_near_far": True,
                  "enable_nablas_input": True,
                  "learn_indicator_weight": True, "N_upsample_iters": 2,
                  "N_samples": 16},
        "training": dict(
            common, num_iters=NEUMESH_ITERS,
            loss_weights={"img": 1.0, "mask": 0.1, "eikonal": 0.1,
                          "distill_density": 1.0, "distill_color": 1.0,
                          "indicator_reg": 0.001},
            teacher_config=os.path.join(teacher, "config.yaml"),
            teacher_ckpt=os.path.join(teacher, "ckpts", "latest.ckpt"))})
    paths = (os.path.join(d, "neus.yaml"), os.path.join(d, "neumesh.yaml"))
    save_yaml(neus, paths[0])
    save_yaml(neumesh, paths[1])
    return paths


def test_neus_extract_neumesh_render_eval(tmp_path, monkeypatch, capsys):
    from neumesh_tpu_torch.cli import eval as eval_cli
    from neumesh_tpu_torch.cli import extract_mesh, render, train
    from neumesh_tpu_torch.dataio.synthetic import generate_sphere_scene
    d = str(tmp_path)
    monkeypatch.chdir(d)
    generate_sphere_scene(os.path.join(d, "scene"), n_views=6, H=36, W=36)
    neus_cfg, neumesh_cfg = configs(d)
    dev = ["--device", "cpu"]

    # 1. the teacher
    out = train.main(["--config", neus_cfg] + dev)
    assert out["it"] == NEUS_ITERS
    teacher = os.path.join(d, "logs", "neus_sphere")
    for name in ("latest.ckpt", f"final_{NEUS_ITERS:08d}.ckpt"):
        assert os.path.exists(os.path.join(teacher, "ckpts", name))

    # 2. the prior mesh, from the teacher's saved config and checkpoint
    stats = {}
    mesh = extract_mesh.main(
        ["--config", os.path.join(teacher, "config.yaml"), "--N_grid", "56",
         "--x_range", "-0.8", "0.8", "--y_range", "-0.8", "0.8",
         "--z_range", "-0.8", "0.8", "--chunk", "16384",
         "--output_dir", os.path.join(d, "mesh")] + dev, stats=stats)
    radii = np.linalg.norm(mesh.vertices, axis=-1)
    assert mesh.n_vertices > 300
    assert abs(np.median(radii) - 0.5) < 0.12, np.median(radii)
    assert radii.std() < 0.08
    assert mesh.vertex_colors is not None
    assert np.isfinite(mesh.vertex_colors).all()
    assert os.path.exists(os.path.join(d, "mesh", "bbox_0.json"))
    assert set(stats) == {"grid_s", "march_s", "color_s"}

    # the teacher scores through the eval CLI too
    neus_eval = eval_cli.main(
        ["--config", os.path.join(teacher, "config.yaml"), "--views", "1",
         "--downscale", "2", "--rayschunk", "324"] + dev)
    assert np.isfinite(neus_eval["mean_psnr"])

    # 3. the student, distilled from the teacher on that mesh
    out = train.main(["--config", neumesh_cfg] + dev)
    student = os.path.join(d, "logs", "neumesh_sphere")
    assert os.path.exists(os.path.join(student, "ckpts", "latest.ckpt"))
    assert out["model"].mesh_grid.get_number_of_vertices() == \
        mesh.n_vertices

    # 4. a render of the student, 5. its scores
    view = render.main(["--config", os.path.join(student, "config.yaml"),
                        "--num_views", "1", "--H", "24", "--W", "24",
                        "--rayschunk", "576"] + dev)
    rgb = view["rgb"][0]
    assert rgb.shape == (24, 24, 3) and np.isfinite(rgb).all()
    capsys.readouterr()
    summary = eval_cli.main(
        ["--config", os.path.join(student, "config.yaml"), "--views", "0,3",
         "--downscale", "2", "--rayschunk", "324", "--out_json",
         "eval.json"] + dev)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["n_views"] == 2
    assert [r["view"] for r in summary["views"]] == [0, 3]
    for r in summary["views"]:
        assert np.isfinite(r["psnr"]) and r["psnr"] > 8
        assert np.isfinite(r["ssim"])
    assert json.load(open("eval.json")) == summary
