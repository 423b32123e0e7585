"""Checkpoints across the two packages: the port's stdlib msgpack decoder
against flax.serialization on `.ckpt` files the JAX package's
CheckpointIO writes, port-written `.ckpt` files read by the JAX package's
load_checkpoint + state-dict converters (the same forward), the
ckpt_ignore_keys / ckpt_only_use_keys filters, and the teacher loaded from
either kind."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from neumesh_tpu.utils.checkpoints import CheckpointIO as JCheckpointIO
from neumesh_tpu.utils.checkpoints import load_checkpoint as jax_load
from neumesh_tpu.utils.torch_ckpt import (neumesh_state_dict_to_params,
                                          neus_state_dict_to_params)
from neumesh_tpu_torch.utils.checkpoints import (CheckpointIO,
                                                 load_checkpoint,
                                                 msgpack_restore)
from neumesh_tpu_torch.utils.state import params_tree
from test_torch_basics import small_scene
from test_torch_train_step import (  # noqa: F401
    one_torch_thread, tiny_teacher)


def _assert_trees_equal(a, b, path="root"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, a.keys(),
                                                          b.keys())
        for k in b:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a.astype(np.float64)
                                      if b.dtype == jnp.bfloat16 else a,
                                      b.astype(np.float64)
                                      if b.dtype == jnp.bfloat16 else b,
                                      err_msg=path)
    else:
        assert type(a) is type(b) or (isinstance(a, float)
                                      and isinstance(b, float)), path
        assert a == b or (a != a and b != b), (path, a, b)


def test_msgpack_decoder_matches_flax(tmp_path, monkeypatch):
    """A NeuS param tree with its optax Adam state and scalars, written by
    the JAX package's CheckpointIO; plus every msgpack type and flax's
    chunked arrays (chunk size cut to 64 bytes)."""
    from neumesh_tpu.config import ConfigDict
    from neumesh_tpu.train.optimizers import get_optimizer
    jn, jp, _ = tiny_teacher(seed=4)
    cfg = ConfigDict({"training": {"lr": 5e-4, "num_iters": 10,
                                   "scheduler": {"type": "warmupcosine",
                                                 "warmup_steps": 2}}})
    opt = get_optimizer(cfg, jp)
    io = JCheckpointIO(str(tmp_path))
    path = io.save("latest.ckpt", model=jp, optimizer=opt.init(jp),
                   global_step=7, epoch_idx=0)
    data = open(path, "rb").read()
    _assert_trees_equal(msgpack_restore(data),
                        serialization.msgpack_restore(data))
    assert load_checkpoint(path)["global_step"] == 7

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {"big": rng.normal(size=(7, 5)).astype(np.float32),
            "bf16": np.asarray(jnp.asarray(rng.normal(size=(3,)),
                                           jnp.bfloat16)),
            "i64": np.arange(-3, 40, dtype=np.int64),
            "scalars": {"neg": -5, "neg_big": -(2 ** 40), "u": 2 ** 40,
                        "f": 0.25, "t": True, "f0": False, "n": None,
                        "s": "x" * 40, "empty": {}},
            "np_scalar": np.float32(1.5), "lst": [1, 2.5, "a"]}
    data = serialization.msgpack_serialize(tree)
    _assert_trees_equal(msgpack_restore(data),
                        serialization.msgpack_restore(data))


def test_port_ckpt_read_by_jax(tmp_path):
    """The port writes a torch zip in the reference layout; the JAX package
    reads it through its zip sniff and its converters into the same
    parameters (same forward)."""
    jm, _, tm = small_scene(seed=5, subdivisions=2)
    jn, jp, tn = tiny_teacher(seed=6)
    io = CheckpointIO(str(tmp_path))
    for model, name in ((tm, "neumesh.ckpt"), (tn, "neus.ckpt")):
        path = io.save(name, model=model, optimizer={"count": 3},
                       global_step=11, epoch_idx=2)
        assert not os.path.exists(path + ".tmp")
        ck = jax_load(path)
        assert int(ck["global_step"]) == 11 and int(ck["epoch_idx"]) == 2
        if model is tm:
            params = neumesh_state_dict_to_params(ck["model"], jm)
            want = jax.tree.map(np.asarray, params)
        else:
            params = neus_state_dict_to_params(ck["model"], jn)
            want = jax.tree.map(np.asarray, params)
            for a, b in zip(jax.tree_util.tree_leaves(want),
                            jax.tree_util.tree_leaves(
                                jax.tree.map(np.asarray, jp))):
                np.testing.assert_array_equal(a, b)
            continue
        got = params_tree(tm)
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(a, b)
        rng = np.random.default_rng(3)
        x = rng.uniform(-0.6, 0.6, (2, 5, 3)).astype(np.float32)
        d = rng.normal(size=(2, 5, 3)).astype(np.float32)
        jsdf, jrgb = jax.jit(jm.forward)(params, jnp.asarray(x),
                                         jnp.asarray(d))
        with torch.no_grad():
            tsdf, trgb = tm.forward(torch.from_numpy(x), torch.from_numpy(d))
        np.testing.assert_allclose(tsdf.numpy(), np.asarray(jsdf),
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb),
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("native", [False, True])
def test_ignore_and_only_filters(tmp_path, native):
    """Filtered top-level keys keep the model's own values, for a port
    checkpoint and for a native JAX one."""
    _, _, src = small_scene(seed=7, subdivisions=2)
    _, _, dst = small_scene(seed=8, subdivisions=2)
    before = params_tree(dst)
    if native:
        JCheckpointIO(str(tmp_path)).save(
            "a.ckpt", model=jax.tree.map(jnp.asarray, params_tree(src)),
            global_step=3)
    else:
        CheckpointIO(str(tmp_path)).save("a.ckpt", model=src, global_step=3)
    io = CheckpointIO(str(tmp_path))
    io.load_file("a.ckpt", dst, ignore_keys=["geometry_features",
                                             "pts_linears"])
    got, want = params_tree(dst), params_tree(src)
    np.testing.assert_array_equal(got["geometry_features"],
                                  before["geometry_features"])
    np.testing.assert_array_equal(got["pts_linears"][1]["v"],
                                  before["pts_linears"][1]["v"])
    np.testing.assert_array_equal(got["color_features"],
                                  want["color_features"])
    np.testing.assert_array_equal(got["views_linears"][0]["w"],
                                  want["views_linears"][0]["w"])
    _, _, dst = small_scene(seed=8, subdivisions=2)
    io.load_file("a.ckpt", dst, only_use_keys=["color_features"])
    got = params_tree(dst)
    np.testing.assert_array_equal(got["color_features"],
                                  want["color_features"])
    np.testing.assert_array_equal(got["ln_s"], before["ln_s"])
    np.testing.assert_array_equal(got["color_linear"]["w"],
                                  before["color_linear"]["w"])
    with pytest.raises(ValueError, match="exclusive"):
        io.load_file("a.ckpt", dst, ignore_keys=["ln_s"],
                     only_use_keys=["ln_s"])


@pytest.mark.parametrize("native", [False, True])
def test_load_teacher_from_either_kind(tmp_path, native):
    """load_teacher on a NeuS config and a native JAX `.ckpt` or a port
    `.ckpt`: the teacher's forward equals the JAX NeuS's."""
    from neumesh_tpu_torch.config import ConfigDict, save_yaml
    from neumesh_tpu_torch.models.neumesh import load_teacher
    from test_torch_train_step import SMALL_NEUS
    jn, jp, tn = tiny_teacher(seed=9)
    s, r = SMALL_NEUS["surface_cfg"], SMALL_NEUS["radiance_cfg"]
    cfg = ConfigDict({
        "data": {}, "model": {
            "framework": "NeuS", "obj_bounding_radius": 1.0,
            "W_geometry_feature": SMALL_NEUS["W_geo_feat"],
            "surface": dict(s, skips=list(s["skips"])), "radiance": dict(r)},
        "training": {"speed_factor": 10.0,
                     "loss_weights": {"img": 1.0, "mask": 1.0}}})
    save_yaml(cfg, str(tmp_path / "neus.yaml"))
    if native:
        path = JCheckpointIO(str(tmp_path)).save("t.ckpt", model=jp,
                                                 global_step=1)
    else:
        path = CheckpointIO(str(tmp_path)).save("t.ckpt", model=tn)
    teacher = load_teacher(str(tmp_path / "neus.yaml"), path, device="cpu")
    assert not any(p.requires_grad for p in teacher.parameters())
    x = np.random.default_rng(1).uniform(-0.7, 0.7, (4, 6, 3)).astype(
        np.float32)
    d = np.random.default_rng(2).normal(size=(4, 6, 3)).astype(np.float32)
    want = jax.jit(jn.forward)(jp, jnp.asarray(x), jnp.asarray(d))
    got = teacher.forward(torch.from_numpy(x), torch.from_numpy(d))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-4)
