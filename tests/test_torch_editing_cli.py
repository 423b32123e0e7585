"""The port's editing entry points end to end at --device cpu on a tiny
example scene that the port's make_example_scene writes into tmp_path
(4 views of 32x32, untrained checkpoints): the four CLIs
(neumesh_tpu_torch.cli.editing), the editing gate and the alignment tool;
the swap CLI's T_r_m and edit_color_features against the JAX package's
TextureSwappingRender on the same files; every entry point defaulting to
the card and raising without one."""
import json
import os

import numpy as np
import pytest
import torch

from neumesh_tpu_torch.cli.editing import paint as paint_cli
from neumesh_tpu_torch.cli.editing import render_geometry_editing as geo_cli
from neumesh_tpu_torch.cli.editing import render_texture_filling as fill_cli
from neumesh_tpu_torch.cli.editing import render_texture_swapping as swap_cli
from neumesh_tpu_torch.tools import editing_gate, make_example_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER = ["--camera_inds", "0", "--rayschunk", "1024", "--device", "cpu"]
CONFIGS = {"swap": "texture_swapping_sphere", "fill": "texture_filling_sphere",
           "geometry": "geometry_editing_sphere", "paint": "paint_sphere"}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The example scene and the shipped editing configs pointed at it."""
    root = str(tmp_path_factory.mktemp("editing") / "scene")
    make_example_scene.main(root, 0, n_views=4, hw=32, device="cpu")
    configs = {}
    for key, name in CONFIGS.items():
        with open(os.path.join(REPO, "configs", "editing", name + ".json")) \
                as f:
            text = f.read().replace("examples/scene", root)
        configs[key] = os.path.join(root, name + ".json")
        with open(configs[key], "w") as f:
            f.write(text)
    return root, configs


def _frames(out):
    assert len(out["rgb"]) == 1
    for rgb in out["rgb"]:
        assert rgb.shape == (32, 32, 3) and np.isfinite(rgb).all()
    assert all(os.path.exists(f) for f in out["files"])


def test_make_example_scene_writes_under_its_root(scene):
    root, _ = scene
    assert sorted(os.listdir(root)) == sorted(
        ["data", "paint_data", "prior_mesh.ply", "neus", "neumesh",
         "editing"] + [n + ".json" for n in CONFIGS.values()])
    assert sorted(os.listdir(os.path.join(root, "editing"))) == [
        "corr.json", "deformed.ply", "mask_bottom.ply", "mask_top.ply",
        "uv_main.ply", "uv_ref.ply"]
    assert len(os.listdir(os.path.join(root, "paint_data", "paint_mask"))) \
        == 4
    assert not os.path.exists(os.path.join(REPO, "examples", "scene",
                                           "neumesh", "ckpts"))


def test_swap_cli_transfer_matches_jax(scene, tmp_path, monkeypatch):
    """The JSON's corr estimate (Umeyama + ICP) and the Kc = 4 transfer:
    T_r_m to 1e-9 and the edit features to 1e-6 against the JAX
    package's TextureSwappingRender on the same files."""
    from neumesh_tpu.config import ConfigDict as JConfig
    from neumesh_tpu.editing.swap import TextureSwappingRender as JSwap
    _, configs = scene
    monkeypatch.chdir(tmp_path)
    out = swap_cli.main(["--config", configs["swap"], *RENDER])
    _frames(out["render"])
    with open(configs["swap"]) as f:
        cfg = JConfig(json.load(f))
    js = JSwap()
    main_prim, _, _ = js.read_data(cfg.main_config, cfg.main_mask_mesh,
                                   cfg.main_ckpt)
    ref_prim, _, _ = js.read_data(cfg.ref_config[0], [cfg.ref_mask_mesh[0]],
                                  cfg.ref_ckpt[0])
    T = js.transfer_texture_features(cfg, main_prim, [ref_prim])
    np.testing.assert_allclose(out["T_r_m"], T, atol=1e-9)
    np.testing.assert_allclose(out["model"].rot_s_m.numpy(),
                               np.asarray(T, np.float32)[:, :3, :3])
    got = out["model"].edit_features(0).numpy()
    want = np.asarray(main_prim.edit_color_features)
    assert np.abs(want).sum() > 0
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert {"load_s", "transfer_s", "knn_s", "align_s"} <= set(out["stats"])


@pytest.mark.parametrize("case", ["swap_arap", "swap_surface", "fill",
                                  "geometry"])
def test_editing_cli_renders(scene, tmp_path, monkeypatch, case):
    root, configs = scene
    monkeypatch.chdir(tmp_path)
    if case == "swap_arap":
        out = swap_cli.main(["--config", configs["swap"], "--use_arap",
                             *RENDER])
        ref = out["model"].ref_models[0]
        moved = np.abs(ref.mesh_grid.mesh.vertices - make_example_scene.
                       icosphere_mesh(0.5, 3).vertices).max()
        assert moved > 1e-3 and "arap_s" in out["stats"]
        assert ref.mesh_grid.vertices.shape[0] == ref.num_vertices
    elif case == "swap_surface":
        out = swap_cli.main(["--config", configs["swap"], "--render_mode",
                             "surface", "--surface_ray_tile", "16",
                             "--surface_scan", "distance", *RENDER])
    elif case == "fill":
        out = fill_cli.main(["--config", configs["fill"], *RENDER])
        assert out["T_r_m"] is None
        ef = out["model"].edit_features(0).numpy()
        assert 0 < (np.abs(ef).sum(-1) > 0).sum() < len(ef)
    else:
        out = geo_cli.main(["--config", configs["geometry"], *RENDER])
        wave = make_example_scene.deformed_mesh(
            make_example_scene.icosphere_mesh(0.5, 3))
        np.testing.assert_allclose(
            out["model"].mesh_grid.vertices.numpy(),
            wave.vertices.astype(np.float32), atol=1e-6)
        assert "meshgrid_s" in out["stats"]
    _frames(out["render"])


@pytest.mark.parametrize("mode,flags", [
    ("volume", ["--volume_devices"]),
    ("surface", ["--render_mode", "surface", "--surface_ray_tile", "16",
                 "--surface_scan", "distance", "--surface_devices"])])
def test_swap_cli_over_two_cpu_replicas_matches_one_device(
        scene, tmp_path, monkeypatch, mode, flags):
    """The swap CLI's editable over two CPU replicas (replicate copies the
    main and reference models inside it): the frame of one device (f32
    rounding as test_torch_multidevice.py allows)."""
    _, configs = scene
    monkeypatch.chdir(tmp_path)
    outs = [swap_cli.main(["--config", configs["swap"], *flags, n,
                           "--outbase", f"{mode}{n}", *RENDER])["render"]
            for n in ("1", "2")]
    for out in outs:
        _frames(out)
    for key in ("rgb", "normals", "depth"):
        np.testing.assert_allclose(outs[1][key][0], outs[0][key][0],
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_paint_cli_trains_only_painted_rows(scene, tmp_path):
    """Three painting steps at a batch of 16: the painted rows of
    color_features move, every other parameter keeps the checkpoint's
    value, every loss is finite, the final checkpoint is written."""
    from neumesh_tpu_torch.editing.renderer_base import \
        load_neumesh_from_config
    root, configs = scene
    with open(configs["paint"]) as f:
        cfg = json.load(f)
    cfg.update(num_iters=3, batch_size=16)
    path = str(tmp_path / "paint.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    out = paint_cli.main(["--config", path, "--device", "cpu"])
    assert out["it"] == 3 and os.path.exists(out["ckpt"])
    assert all(np.isfinite(list(step.values())).all()
               for step in out["losses"])
    before, _, _ = load_neumesh_from_config(cfg["main_config"],
                                            cfg["ckpt_path"], "cpu")
    idx = out["optimized_indices"]
    assert 0 < len(idx) < before.num_vertices
    after = dict(out["model"].named_parameters())
    for name, p0 in before.named_parameters():
        p = after[name].detach()
        if name == "color_features":
            rest = np.setdiff1d(np.arange(p.shape[0]), idx)
            assert torch.equal(p[rest], p0[rest])
            assert (p[idx] != p0[idx]).any()
        else:
            assert torch.equal(p, p0), name


def test_editing_gate_cli(scene):
    """The gate's JSON keys (the JAX gate's), finite values, the file."""
    root, _ = scene
    cfg = os.path.join(root, "neumesh", "config.yaml")
    out = os.path.join(root, "gate.json")
    res = editing_gate.main(["--config", cfg, "--views", "1", "--device",
                             "cpu", "--out", out])
    assert set(res) == {"scene", "n_main_mask", "n_ref_mask",
                        "untouched_delta_db", "swapped_mean_abs_diff",
                        "swapped_edit_vs_orig_db", "gate_edit_untouched",
                        "gate_edit_swapped"}
    assert np.isfinite([res["untouched_delta_db"],
                        res["swapped_mean_abs_diff"]]).all()
    with open(out) as f:
        assert json.load(f) == res


def test_mesh_alignment_tool(scene, tmp_path):
    from neumesh_tpu.editing.align import estimate_transform_from_corr
    from neumesh_tpu_torch.mesh.triangle_mesh import load_mesh
    from neumesh_tpu_torch.tools import mesh_alignment
    root, configs = scene
    with open(os.path.join(root, "editing", "corr.json")) as f:
        corr = json.load(f)["corr"]
    corr_path = str(tmp_path / "corr.json")
    with open(corr_path, "w") as f:
        json.dump(corr, f)
    cfg = str(tmp_path / "edit.json")
    with open(cfg, "w") as f:
        json.dump({"main_config": "x"}, f)
    mesh = os.path.join(root, "prior_mesh.ply")
    T = mesh_alignment.main(["--main_mesh", mesh, "--ref_mesh", mesh,
                             "--corr", corr_path, "--out_config", cfg])
    v = load_mesh(mesh).vertices
    np.testing.assert_allclose(
        T, estimate_transform_from_corr(v, v, np.asarray(corr)), atol=1e-9)
    with open(cfg) as f:
        data = json.load(f)
    np.testing.assert_allclose(data["T_r_m"][0], T)
    assert data["corr"][0] == corr


@pytest.mark.parametrize("entry", ["swap", "fill", "geometry", "paint",
                                   "gate"])
def test_editing_entry_points_default_to_cuda(scene, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    root, configs = scene
    argv = ["--config", configs.get(entry, "")]
    fn = {"swap": swap_cli.main, "fill": fill_cli.main,
          "geometry": geo_cli.main, "paint": paint_cli.main}.get(entry)
    if entry == "gate":
        fn = editing_gate.main
        argv = ["--config", os.path.join(root, "neumesh", "config.yaml")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(argv)


def test_paint_cli_and_the_benchmark_share_the_step(scene, tmp_path,
                                                    monkeypatch):
    """The paint CLI and the benchmark's painting driver
    (benchmark/kinds/paint.py) each set up through
    paint_train.build_paint_step, which builds build_train_step's painting
    step, and train with that step alone."""
    from neumesh_tpu_torch.editing import paint_train
    from test_torch_paint_reference import _tiny_paint
    setups, steps = [], []
    setup, build = paint_train.build_paint_step, paint_train.build_train_step

    def recorded_setup(*a, **kw):
        setups.append(a[1].model)
        return setup(*a, **kw)

    def recorded_build(*a, **kw):
        step = build(*a, **kw)
        calls = []
        steps.append((kw.get("painting"), calls))

        def counted(*sa, **skw):
            calls.append(1)
            return step(*sa, **skw)
        return counted
    monkeypatch.setattr(paint_train, "build_paint_step", recorded_setup)
    monkeypatch.setattr(paint_train, "build_train_step", recorded_build)
    _, configs = scene
    with open(configs["paint"]) as f:
        cfg = json.load(f)
    cfg.update(num_iters=2, batch_size=16)
    path = str(tmp_path / "paint.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    out = paint_cli.main(["--config", path, "--device", "cpu"])
    assert setups == [out["model"]]
    assert [(p, len(c)) for p, c in steps] == [(True, 2)]
    d = _tiny_paint(monkeypatch, 5)
    assert len(setups) == 2 and setups[1] is d.model
    assert [(p, len(c)) for p, c in steps] == [(True, 2), (True, 3)]
    d.step()
    assert len(steps[1][1]) == 4
