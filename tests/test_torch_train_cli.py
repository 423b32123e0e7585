"""The training CLI (neumesh_tpu_torch.cli.train, the counterpart of
train.py) on the CPU: the shipped NeuS config, cut to a small width, on a
4-view 32x32 synthetic scene for 3 iterations; then the shipped NeuMesh
config distilled from the teacher's .ckpt just written, 3 iterations;
checkpoint names, resume with the optimizer state, and the render CLI on
the NeuMesh config (only its paths changed) and its final checkpoint."""
import os

import numpy as np
import pytest
import torch

from test_torch_train_step import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_NEUS = ["--model:surface:D", "3", "--model:surface:W", "32",
              "--model:surface:skips", "[2]", "--model:surface:embed_multires",
              "2", "--model:radiance:D", "2", "--model:radiance:W", "32",
              "--model:W_geometry_feature", "16"]
SMALL_NEUMESH = ["--model:W", "32", "--model:D_color", "2",
                 "--model:geometry_dim", "8", "--model:color_dim", "8",
                 "--model:multires_d", "4", "--model:multires_fg", "1",
                 "--model:multires_ft", "1", "--model:multires_view", "2"]
RUN = ["--data:N_rays", "32", "--data:downscale", "1",
       "--data:val_downscale", "4", "--data:cam_file", "cameras.npz",
       "--model:N_samples", "16", "--model:N_importance", "8",
       "--training:num_iters", "3", "--training:i_val", "2",
       "--training:i_backup", "2", "--training:i_log", "1",
       "--training:monitoring", "none", "--training:log_root_dir", "logs",
       "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from neumesh_tpu_torch.cli import train
    from neumesh_tpu_torch.dataio.synthetic import (generate_sphere_scene,
                                                    icosphere_mesh)
    from neumesh_tpu_torch.mesh.triangle_mesh import save_ply
    d = tmp_path_factory.mktemp("train")
    scene = generate_sphere_scene(str(d / "scene"), n_views=4, H=32, W=32,
                                  focal=40.0)
    save_ply(icosphere_mesh(0.5, 2), str(d / "mesh.ply"))
    cwd = os.getcwd()
    os.chdir(d)
    try:
        neus = train.main(["--config", os.path.join(
            REPO, "configs", "neus_dtu_scan63.yaml"), "--data:data_dir",
            scene, "--expname", "neus"] + SMALL_NEUS + RUN)
        teacher = os.path.join("logs", "neus")
        neumesh = train.main(["--config", os.path.join(
            REPO, "configs", "neumesh_dtu_scan63.yaml"), "--data:data_dir",
            scene, "--expname", "neumesh",
            "--model:prior_mesh", str(d / "mesh.ply"),
            "--training:teacher_config",
            os.path.join(teacher, "config.yaml"),
            "--training:teacher_ckpt",
            os.path.join(teacher, "ckpts", "latest.ckpt")]
            + SMALL_NEUMESH + RUN)
        yield d, scene, neus, neumesh
    finally:
        os.chdir(cwd)


def test_checkpoint_names_and_losses(trained):
    d, _, neus, neumesh = trained
    for run in (neus, neumesh):
        assert run["it"] == 3
        ckpts = sorted(os.listdir(os.path.join(run["exp_dir"], "ckpts")))
        assert ckpts == ["00000002.ckpt", "final_00000003.ckpt",
                         "latest.ckpt"]
        assert os.path.exists(os.path.join(run["exp_dir"], "config.yaml"))
        assert os.path.exists(os.path.join(run["exp_dir"], "stats.p_0"))
        ck = torch.load(os.path.join(run["exp_dir"], "ckpts", "latest.ckpt"),
                        weights_only=True)
        assert ck["global_step"] == 3 and ck["optimizer"]["count"] == 3
        import pickle
        with open(os.path.join(run["exp_dir"], "stats.p_0"), "rb") as f:
            stats = pickle.load(f)
        for k, v in stats["losses"].items():
            assert len(v) == 3 and np.isfinite([x for _, x in v]).all(), k
    keys = set(pickle.load(open(os.path.join(neumesh["exp_dir"],
                                             "stats.p_0"), "rb"))["losses"])
    assert keys == {"loss_img", "loss_mask", "loss_eikonal", "loss_density",
                    "loss_color", "loss_indicator_vector_reg", "total"}
    # the teacher's ln_s is the one it was saved with; the student's moved
    teacher = neumesh["trainer"].teacher_model
    saved = torch.load(os.path.join(neus["exp_dir"], "ckpts", "latest.ckpt"),
                       weights_only=True)["model"]["ln_s"]
    torch.testing.assert_close(teacher.ln_s.detach(), saved, rtol=0, atol=0)
    assert not torch.equal(neumesh["model"].ln_s.detach(), saved)
    # validation images at i_val crossings (it 0 and 2)
    imgs = os.listdir(os.path.join(neumesh["exp_dir"], "imgs",
                                   "val", "predicted_rgb"))
    assert sorted(imgs) == ["00000000_0.png", "00000002_0.png"]


def test_resume_continues_from_latest(trained):
    """--resume_dir reloads config.yaml and latest.ckpt (parameters and the
    optimizer's count) and trains on to the new num_iters."""
    from neumesh_tpu_torch.cli import train
    d, _, neus, _ = trained
    cwd = os.getcwd()
    os.chdir(d)
    try:
        out = train.main(["--resume_dir", neus["exp_dir"],
                          "--training:num_iters", "5", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert out["it"] == 5
    ck = torch.load(os.path.join(neus["exp_dir"], "ckpts", "latest.ckpt"),
                    weights_only=True)
    assert ck["global_step"] == 5 and ck["optimizer"]["count"] == 5
    assert "final_00000005.ckpt" in os.listdir(
        os.path.join(neus["exp_dir"], "ckpts"))


@pytest.mark.parametrize("run", ["neumesh", "neus"])
def test_render_cli_takes_the_trained_configs(trained, run):
    """cli/render.py on each run's config.yaml (the shipped configs with
    their paths changed) and its final checkpoint: the NeuMesh config loads
    its teacher again; one finite view is rendered."""
    from neumesh_tpu_torch.cli import render
    d, _, neus, neumesh = trained
    exp = (neumesh if run == "neumesh" else neus)["exp_dir"]
    cwd = os.getcwd()
    os.chdir(d)
    try:
        out = render.main([
            "--config", os.path.join(exp, "config.yaml"),
            "--load_pt", os.path.join(exp, "ckpts", "final_00000003.ckpt"),
            "--num_views", "1", "--H", "8", "--W", "8",
            "--rayschunk", "256", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert out["rgb"][0].shape == (8, 8, 3)
    assert np.isfinite(out["rgb"][0]).all()
