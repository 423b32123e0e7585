"""The training loop's debugging keys (counterparts of
neumesh_tpu/train/loop.py's debug_nans and profile_dir), through the
port's main_function on the CPU with a tiny NeuMesh: with debug_nans a
non-finite loss raises FloatingPointError (and anomaly detection is off
again afterwards); with profile_dir the run writes a torch.profiler
Chrome trace."""
import json
import math
import os

import pytest
import torch

from test_torch_train_step import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from neumesh_tpu_torch.dataio.synthetic import (generate_sphere_scene,
                                                    icosphere_mesh)
    from neumesh_tpu_torch.mesh.triangle_mesh import save_ply
    root = tmp_path_factory.mktemp("dbg")
    generate_sphere_scene(str(root / "scene"), n_views=2, H=16, W=16,
                          focal=30.0)
    save_ply(icosphere_mesh(0.5, 2), str(root / "prior.ply"))
    return root


def config(root, expname, **training):
    """A fresh experiment (its own log directory: nothing to resume)."""
    from neumesh_tpu_torch.config import ConfigDict
    return ConfigDict({
        "expname": expname, "device": "cpu",
        "data": {"type": "DTU", "data_dir": str(root / "scene"),
                 "downscale": 1, "N_rays": 16, "batch_size": 1,
                 "obj_bounding_radius": 1.0},
        "model": {"framework": "NeuMesh",
                  "prior_mesh": str(root / "prior.ply"), "D_density": 2,
                  "D_color": 2, "W": 16, "geometry_dim": 4, "color_dim": 4,
                  "multires_d": 2, "multires_fg": 1, "multires_ft": 1,
                  "multires_view": 1, "N_upsample_iters": 1,
                  "N_samples": 8, "N_importance": 4},
        "training": {"speed_factor": 10.0, "lr": 1e-3, "num_iters": 2,
                     "scheduler": {"type": "warmupcosine",
                                   "warmup_steps": 0},
                     "loss_weights": {"img": 1.0, "mask": 0.1,
                                      "eikonal": 0.1},
                     "log_root_dir": str(root / "logs"), "i_val": -1,
                     "i_backup": -1, "i_log": 1, "monitoring": "none",
                     **training}})


def test_debug_nans_raises_on_a_nan_loss(scene):
    """lr = NaN: the first update makes every trained parameter NaN, so
    the second step's loss is NaN and the loop raises before backward."""
    from neumesh_tpu_torch.train.loop import main_function
    with pytest.raises(FloatingPointError, match="non-finite total loss"):
        main_function(config(scene, "nan_debug", lr=math.nan, num_iters=3,
                             debug_nans=True))
    assert not torch.is_anomaly_enabled()
    # without the key the same run finishes (the NaN goes unchecked)
    out = main_function(config(scene, "nan", lr=math.nan, num_iters=3))
    assert out["it"] == 3 and torch.isnan(out["model"].ln_s).all()


def test_profile_dir_writes_a_chrome_trace(scene):
    from neumesh_tpu_torch.train.loop import main_function
    prof = scene / "prof"
    out = main_function(config(scene, "prof", profile_dir=str(prof)))
    assert out["it"] == 2
    path = os.path.join(prof, "trace_rank0.json")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names), sorted(names)[:20]
