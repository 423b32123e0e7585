"""The port's eval CLI (neumesh_tpu_torch.cli.eval, --device cpu) against
the repository's eval.py, and the port's parity tool against
tools/parity_eval.py's contract, on test_torch_render_cli.py's 24x24
synthetic DTU-format scene and small NeuMesh (.pt). The port's model
builds its own candidate tables with its default (native) KD-tree, equal
to the JAX package's, so both packages pick the same kNN.
Per-view PSNR within 1e-3 dB and SSIM within 1e-4 (the rows' rounding),
LPIPS (synthetic VGG16 weights through the environment) within 1e-4; the
same JSON keys; the --save_renders PNGs are the returned renders and
agree with eval.py's within one 8-bit level on >= 99% of the pixels."""
import json
import os
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from neumesh_tpu_torch.cli import eval as teval
from neumesh_tpu_torch.ops import kernels
from neumesh_tpu_torch.utils.image_io import read_png
from test_torch_render_cli import cli_scene

__all__ = ["cli_scene"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def lpips_files(tmp_path, monkeypatch):
    """Seeded VGG16 and lin weights written by torch.save, named by the
    environment variables both packages read."""
    from neumesh_tpu_torch.ops.lpips import _CHANNELS, _VGG_CONVS
    g = torch.Generator().manual_seed(3)
    sd, in_c = {}, 3
    for out_c, idx in _VGG_CONVS:
        sd[f"features.{idx}.weight"] = torch.randn(
            out_c, in_c, 3, 3, generator=g) / np.sqrt(in_c * 9)
        sd[f"features.{idx}.bias"] = torch.zeros(out_c)
        in_c = out_c
    torch.save(sd, str(tmp_path / "vgg16.pth"))
    torch.save({f"lin{k}.model.1.weight": torch.rand(1, c, 1, 1,
                                                     generator=g) / c
                for k, c in enumerate(_CHANNELS)}, str(tmp_path / "vgg.pth"))
    monkeypatch.setenv("NEUMESH_LPIPS_VGG", str(tmp_path / "vgg16.pth"))
    monkeypatch.setenv("NEUMESH_LPIPS_LIN", str(tmp_path / "vgg.pth"))


def jax_eval(flags):
    """eval.py's main_function on the same flags as the port's CLI."""
    sys.path.insert(0, REPO)
    import eval as jeval
    from neumesh_tpu.config import create_args_parser, load_config
    from neumesh_tpu_torch.cli.eval import create_eval_args
    parser = create_eval_args(create_args_parser())
    args, unknown = parser.parse_known_args(flags)
    del args.device
    return jeval.main_function(load_config(args, unknown))


def assert_rows_agree(got, want):
    assert got.keys() == want.keys()
    assert [r["view"] for r in got["views"]] == \
        [r["view"] for r in want["views"]]
    for g, w in zip(got["views"], want["views"]):
        assert g.keys() == w.keys()
        assert abs(g["psnr"] - w["psnr"]) <= 1e-3 + 1e-9, (g, w)
        assert abs(g["ssim"] - w["ssim"]) <= 1e-4 + 1e-9, (g, w)
        if "lpips" in w:
            assert abs(g["lpips"] - w["lpips"]) <= 1e-4 + 1e-9, (g, w)
    for k in ("mean_psnr", "mean_ssim", "mean_lpips"):
        if k in want:
            assert abs(got[k] - want[k]) <= (1e-3 if k == "mean_psnr"
                                             else 1e-4) + 1e-9


def test_eval_cli_matches_eval_py(cli_scene, tmp_path, monkeypatch,
                                  lpips_files, capsys):
    cfg, pt = cli_scene
    monkeypatch.chdir(tmp_path)
    flags = ["--config", cfg, "--load_pt", pt, "--views", "0,2",
             "--rayschunk", "256"]
    want = jax_eval(flags + ["--out_json", "jax.json",
                             "--save_renders", "jax_png"])
    capsys.readouterr()
    renders = {}
    kernels.reset_launch_counts()
    got = teval.main(flags + ["--out_json", "port.json", "--save_renders",
                              "port_png", "--device", "cpu"],
                     renders=renders)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"mean_psnr": got["mean_psnr"],
                    "mean_ssim": got["mean_ssim"], "n_views": 2}
    assert all(v == 0 for modes in kernels.LAUNCHES.values()
               for v in modes.values())
    assert "lpips" in got["views"][0] and "mean_lpips" in got
    assert_rows_agree(got, want)
    assert json.load(open("port.json")) == got
    assert json.load(open("jax.json")).keys() == got.keys()
    assert sorted(renders) == [0, 2]
    for vi in (0, 2):
        png = read_png(os.path.join("port_png", f"{vi:06d}.png"))
        np.testing.assert_array_equal(
            png, (np.clip(renders[vi], 0, 1) * 255.0).astype(np.uint8))
        jpng = imageio.imread(os.path.join("jax_png", f"{vi:06d}.png"))
        # eval's reuse of the up-sampling SDF: a near-tie of the
        # inverse-CDF bin count can move one sample (one pixel here off
        # by 2 levels; the rows above agree to their rounding)
        err = np.abs(png.astype(int) - jpng.astype(int)).max(-1)
        assert err.max() <= 2 and (err <= 1).mean() >= 0.99


def test_eval_cli_val_names_and_all_views(cli_scene, tmp_path, monkeypatch):
    """--val_names picks views by image basename; without --views every
    view; a name matching nothing raises; without --device cpu it raises
    (no card here)."""
    cfg, pt = cli_scene
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("NEUMESH_LPIPS_VGG", raising=False)
    (tmp_path / "val.txt").write_text("000001.png\n000003\n")
    base = ["--config", cfg, "--load_pt", pt, "--rayschunk", "576",
            "--downscale", "2", "--device", "cpu"]
    got = teval.main(base + ["--val_names", "val.txt"])
    assert [r["view"] for r in got["views"]] == [1, 3]
    assert "lpips" not in got["views"][0] and "mean_lpips" not in got
    want = jax_eval(base[:-2] + ["--val_names", "val.txt"])
    assert_rows_agree(got, want)
    assert len(teval.main(base)["views"]) == 4
    (tmp_path / "none.txt").write_text("nothing.png\n")
    with pytest.raises(ValueError, match="val_names"):
        teval.main(base + ["--val_names", "none.txt"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            teval.main(base[:-2] + ["--views", "0"])


def test_parity_eval_cli(cli_scene, tmp_path, monkeypatch):
    """The parity tool on the synthetic scene, as tests/test_parity_cli.py
    runs tools/parity_eval.py: our renders against the ground truth, and
    the per-view deltas against reference renders (here the ground truth
    itself, then the renders eval --save_renders wrote: the same weights
    on both sides, so the deltas are PNG quantisation, inside 0.1 dB)."""
    from neumesh_tpu_torch.tools import parity_eval
    cfg, pt = cli_scene
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("NEUMESH_LPIPS_VGG", raising=False)
    data_dir = os.path.join(os.path.dirname(cfg), "scene")
    (tmp_path / "val.txt").write_text("000000.png\n000002.png\n")
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "000000.png").write_bytes(
        open(os.path.join(data_dir, "image", "000000.png"), "rb").read())
    base = ["--config", cfg, "--load_pt", pt, "--val_names", "val.txt",
            "--rayschunk", "576", "--device", "cpu"]
    table = parity_eval.main(base + ["--ref_renders", str(ref),
                                     "--out_json", "parity.json"])
    assert json.load(open("parity.json")) == table
    assert [r["view"] for r in table["ours_vs_gt"]["views"]] == [0, 2]
    rows = table["parity"]["views"]
    assert [r["name"] for r in rows] == ["000000"]
    assert rows[0]["psnr_ref"] > 60            # the ground truth itself
    assert rows[0]["delta_db"] == round(rows[0]["psnr_ours"]
                                        - rows[0]["psnr_ref"], 3)

    teval.main(base + ["--save_renders", "renders"])
    table = parity_eval.main(base + ["--ref_renders", "renders"])
    parity = table["parity"]
    assert [r["name"] for r in parity["views"]] == ["000000", "000002"]
    assert parity["within_0p1_db"] is True
    assert abs(parity["mean_delta_db"]) < 0.1
    with pytest.raises(ValueError, match="same scale"):
        parity_eval.main(base + ["--ref_renders", "renders",
                                 "--downscale", "2"])
